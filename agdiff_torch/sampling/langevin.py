"""Annealed Langevin dynamics, the reference 'ld' update (port of
agdiff_tpu/sampling/langevin.py:100-291, suffix ladder).

Per step i (the last n_steps noise levels, highest first):
    step = step_lr * (sigma_i / 0.01)^2
    pos <- pos + step * eps_pos / sigma_i + sqrt(2 * step) * xi
then non-finite entries are flagged per graph and zeroed, each graph is
re-centred, and positions are optionally clipped. The ladder is a Python
loop over steps; the flags stay on the device, so a run syncs only at the
end. Every forward call gets the config's `extend_order` and
`extend_radius` (agdiff_tpu/sampling/langevin.py:177-189). The forward's
pair list depends only on the node mask: the sampler builds it once per
ladder and passes it to every step (the JAX package's `forward.prepare`
hoist, models/tight_forward.py:388-392). `build_sampler` runs the ladder
on the dense module (models/dualenc.py), `build_fast_sampler` on a folded
forward.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from agdiff_torch.models.schedules import Diffusion
from agdiff_torch.ops.geometry import center_pos, clip_norm, eq_transform_dense


@dataclass(frozen=True)
class SamplerConfig:
    """Sampling hyperparameters (reference scripts/test.py defaults)."""

    n_steps: int = 5000
    step_lr: float = 1.0e-6
    w_global: float = 1.0
    global_start_sigma: float = 0.5
    clip: float = 1000.0
    clip_local: Optional[float] = None
    clip_pos: Optional[float] = None
    extend_order: bool = False   # the test-time adjacency is pre-extended
    extend_radius: bool = True

    def with_clip_local(self, value: float) -> "SamplerConfig":
        return dataclasses.replace(self, clip_local=value)


class SampleResult(NamedTuple):
    pos: torch.Tensor        # (B, N, 3)
    nan_flags: torch.Tensor  # (B,) bool: a non-finite value appeared


def assemble_drift(out, pos, sigma, cfg: SamplerConfig):
    """eps_pos from a model output: the local branch (optionally clipped)
    plus the global branch, gated on once sigma < global_start_sigma."""
    node_eq_local = eq_transform_dense(out.edge_inv_local, pos,
                                       out.local_mask, out.edge_length)
    if cfg.clip_local is not None:
        node_eq_local = clip_norm(node_eq_local, cfg.clip_local)
    inv_global = out.edge_inv_global * (1.0 - out.local_mask.float())
    node_eq_global = clip_norm(
        eq_transform_dense(inv_global, pos, out.edge_mask, out.edge_length),
        cfg.clip)
    # where, not multiply-by-zero: an inactive branch never injects NaN
    node_eq_global = torch.where(sigma < cfg.global_start_sigma,
                                 node_eq_global,
                                 torch.zeros_like(node_eq_global))
    return node_eq_local + node_eq_global * cfg.w_global


def langevin_dynamics_sample(forward_fn: Callable, batch, pos_init,
                             diffusion: Diffusion, config: SamplerConfig,
                             generator: Optional[torch.Generator] = None,
                             noise: Optional[torch.Tensor] = None,
                             pairs=None) -> SampleResult:
    """Run the ladder. pos_init is standard normal noise (scaled here by the
    largest sigma). The per-step noise comes from `generator`, or from
    `noise` of shape (n_steps, B, N, 3) when given (tests replay the JAX
    package's noise that way). `pairs`, when given, goes to every forward
    call."""
    cfg = config
    dev = batch.pos.device
    sigmas = torch.as_tensor(diffusion.sigmas, dtype=torch.float32,
                             device=dev)
    T = diffusion.num_timesteps
    mask3 = batch.node_mask[..., None].float()
    pos = pos_init * sigmas[-1] * mask3
    nan_flags = torch.zeros(batch.num_graphs, dtype=torch.bool, device=dev)
    if noise is not None and noise.shape[0] != cfg.n_steps:
        raise ValueError(f"noise has {noise.shape[0]} steps, expected "
                         f"{cfg.n_steps}")
    fwd_kwargs = dict(extend_order=cfg.extend_order,
                      extend_radius=cfg.extend_radius)
    if pairs is not None:
        fwd_kwargs["pairs"] = pairs
    for k, i in enumerate(range(T - 1, T - cfg.n_steps - 1, -1)):
        sigma = sigmas[i]
        out = forward_fn(batch.replace(pos=pos), **fwd_kwargs)
        eps_pos = assemble_drift(out, pos, sigma, cfg)
        step_size = cfg.step_lr * (sigma / 0.01) ** 2
        xi = (noise[k].to(dev) if noise is not None else
              torch.randn(pos.shape, generator=generator, device=dev))
        pos_next = (pos + step_size * eps_pos / sigma
                    + xi * mask3 * torch.sqrt(step_size * 2.0))
        finite = torch.isfinite(pos_next)
        nan_flags = nan_flags | ~finite.all(dim=2).all(dim=1)
        pos_next = torch.where(finite, pos_next, torch.zeros_like(pos_next))
        pos = center_pos(pos_next, batch.node_mask)
        if cfg.clip_pos is not None:
            pos = torch.clamp(pos, -cfg.clip_pos, cfg.clip_pos)
    return SampleResult(pos=pos, nan_flags=nan_flags)


def build_sampler(model, diffusion: Diffusion, config: SamplerConfig):
    """A sampler on the dense module path (agdiff_tpu/sampling/langevin.py
    build_sampler): run(batch, pos_init, generator=None, noise=None) ->
    SampleResult, the module in eval mode without gradients."""

    @torch.no_grad()
    def run(batch, pos_init, generator=None, noise=None):
        return langevin_dynamics_sample(model.eval(), batch, pos_init,
                                        diffusion, config,
                                        generator=generator, noise=noise)

    return run


def build_fast_sampler(forward_fn: Callable, diffusion: Diffusion,
                       config: SamplerConfig,
                       pair_capacity: Optional[int] = None):
    """A sampler closure over a forward (models/fast_forward.py,
    models/tight_forward.py): run(batch, pos_init, generator=None,
    noise=None) -> SampleResult. A forward with `prepare` gets its pair
    list built once per ladder, at `pair_capacity` pairs for a tight
    forward; it must hold every graph's real pairs (eval/generate.py
    sizes it)."""

    def run(batch, pos_init, generator=None, noise=None):
        prepare = getattr(forward_fn, "prepare", None)
        pairs = None if prepare is None else prepare(batch, pair_capacity)
        return langevin_dynamics_sample(forward_fn, batch, pos_init,
                                        diffusion, config,
                                        generator=generator, noise=noise,
                                        pairs=pairs)

    return run
