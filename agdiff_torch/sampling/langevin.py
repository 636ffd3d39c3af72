"""The sampler: annealed Langevin dynamics and DDIM over a ladder of noise
levels (port of agdiff_tpu/sampling/langevin.py).

The ladder is a table of (i, j) per step: the current noise level i and
the next one j, -1 after the last (the clean end, sigma 0). `ladder`
'suffix' takes the last n_steps levels of the schedule, highest first
(the reference's semantics); 'strided' takes n_steps levels evenly spaced
over the whole schedule, round(linspace(T - 1, 0, n)) with
round-half-even, in float32 as XLA computes it (`ladder_indices`: float64
or another float32 order lands on the other side of some ties). Per
step, with eps_pos the assembled drift (`assemble_drift`):

* 'ld' (the reference's update): step = step_lr * (sigma_i / 0.01)^2,
  pos <- pos + step * eps_pos / sigma_i + sqrt(2 * step) * xi;
* 'generalized' (DDIM in the model's scaled parameterisation):
  a_j = 1 and sigma_j = 0 at j = -1;
  s2 = clip(eta^2 sigma_j^2 (1 - a_i / a_j) / (1 - a_i), 0, sigma_j^2);
  pos <- pos + (sqrt(sigma_j^2 - s2) - sigma_i) * (-eps_pos) + sqrt(s2) xi,
  the noise added even at eta = 0, as JAX adds it; solver 'heun' (eta 0
  only) evaluates the drift again at the predicted point and sigma_j and
  averages the two slopes; at j = -1 that second evaluation still runs
  and is selected away, so that the step has no branch.

Then non-finite entries are flagged per graph and zeroed, each graph is
re-centred, and positions are optionally clipped. `denoise_tail` adds
noise-free 'ld' steps at the last level; `traj_stride` keeps pos after
every traj_stride steps (the steps left over run after the last entry).

A `Ladder` holds one ladder's state on the device: positions, flags, a
step counter, the (i, j) table and the sigma and alpha tables. Every
per-step scalar is read on the device through the counter, so one block
of steps serves every block of the ladder: it is the function
sampling/graphed.py captures as a CUDA graph and replays, and the eager
loop calls the same function. The ladder runs in blocks of BLOCK_STEPS
steps (traj_stride steps when a trajectory is kept), then the steps left
over, then the tail; each block's noise is one draw of (S, B, N, 3) from
the generator, or the block's slice of an injected `noise` of shape
(n_steps, B, N, 3) (tests replay the JAX package's noise so), so eager
and graphed runs draw the same numbers. The forward's pair list depends
only on the node mask: it is built once per ladder and passed to every
forward call, with the config's `extend_order` and `extend_radius`.
`build_sampler` runs the ladder on the dense module (models/dualenc.py),
`build_fast_sampler` on a folded forward; on a CUDA device both replay
CUDA graphs unless asked for graph=False.

With a data-parallel `group` (parallel/mesh.py; JAX's
`build_fast_sampler(mesh=...)` and `make_parallel_sampler`) a sampler
takes the global batch and its starts, runs the ladder on this rank's
rows with the engine's kernels, and returns every rank's samples and
flags. Each block's noise is the global draw of (S, B, N, 3), of which
the rank's ladder reads its rows, so that the samples are those of one
process running the whole batch. The per-graph engines need no other
collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from agdiff_torch.models.schedules import Diffusion
from agdiff_torch.ops.geometry import center_pos, clip_norm, eq_transform_dense
from agdiff_torch.sampling.graphed import LadderGraphs
from agdiff_torch.utils import profiling

# steps per block of the ladder without a trajectory: a graph of 20 steps
# holds ~3400 device operations on 'pksf' at QM9 width (170 a step, 95 of
# them the forward's: LadderGraphs.nodes), and a 5000-step ladder is 250
# replays of it
BLOCK_STEPS = 20


@dataclass(frozen=True)
class SamplerConfig:
    """Sampling hyperparameters (reference scripts/test.py defaults; the
    fields and defaults of the JAX package's SamplerConfig)."""

    n_steps: int = 5000
    ladder: str = "suffix"       # 'suffix' | 'strided' (module docstring)
    unroll: int = 1              # JAX's scan unroll; no effect here
    step_lr: float = 1.0e-6
    w_global: float = 1.0
    global_start_sigma: float = 0.5
    clip: float = 1000.0
    clip_local: Optional[float] = None
    clip_pos: Optional[float] = None
    extend_order: bool = False   # the test-time adjacency is pre-extended
    extend_radius: bool = True
    traj_stride: int = 0         # 0: no trajectory; k: pos every k steps
    denoise_tail: int = 0        # noise-free 'ld' steps at the last level
    sampling_type: str = "ld"    # 'ld' | 'generalized' (DDIM)
    eta: float = 1.0             # 'generalized' noise: 0 = deterministic
    solver: str = "euler"        # 'generalized': 'euler' | 'heun' (eta 0)

    def with_clip_local(self, value: float) -> "SamplerConfig":
        return dataclasses.replace(self, clip_local=value)


class SampleResult(NamedTuple):
    pos: torch.Tensor        # (B, N, 3)
    nan_flags: torch.Tensor  # (B,) bool: a non-finite value appeared
    traj: Optional[torch.Tensor] = None  # (n_steps // traj_stride, B, N, 3)


def validate(cfg: SamplerConfig) -> None:
    """JAX's checks (agdiff_tpu/sampling/langevin.py:156-163)."""
    if cfg.sampling_type not in ("ld", "generalized"):
        raise ValueError(f"unknown sampling_type {cfg.sampling_type!r}")
    if cfg.solver not in ("euler", "heun"):
        raise ValueError(f"unknown solver {cfg.solver!r}")
    if (cfg.solver == "heun" and cfg.sampling_type == "generalized"
            and cfg.eta != 0.0):
        raise ValueError("solver='heun' integrates the probability-flow "
                         "ODE and requires eta=0")


def ladder_indices(num_timesteps: int, n_steps: int,
                   ladder: str = "suffix") -> np.ndarray:
    """The n_steps noise levels of a ladder, highest first (int64).
    'strided' is jnp.round(jnp.linspace(T - 1, 0, n)) as XLA computes it
    in float32: start * (1 - k * (1 / (n - 1))) for k < n - 1 (XLA turns
    the division by n - 1 into a product with its reciprocal, which
    decides the ties: 16.499996, not 16.500002, at T = 100, n = 7), then
    the end point, rounded half to even."""
    t, n = num_timesteps, n_steps
    if n < 1:
        raise ValueError(f"n_steps={n}: at least one step")
    if ladder == "strided":
        if n == 1:
            out = np.float32([t - 1])
        else:
            frac = np.arange(n - 1, dtype=np.float32) * (
                np.float32(1) / np.float32(n - 1))
            out = np.concatenate([np.float32(t - 1) * (np.float32(1) - frac)
                                  + np.float32(0) * frac, np.float32([0])])
        return np.round(out).astype(np.int64)
    if ladder != "suffix":
        raise ValueError(f"unknown ladder {ladder!r}")
    if n > t:
        raise ValueError(f"n_steps={n} exceeds the schedule's {t} levels")
    return np.arange(t - 1, t - n - 1, -1, dtype=np.int64)


def ladder_table(num_timesteps: int, n_steps: int,
                 ladder: str = "suffix") -> np.ndarray:
    """(n_steps, 2) (i, j) per step: each level and the next, -1 last."""
    idx = ladder_indices(num_timesteps, n_steps, ladder)
    return np.stack([idx, np.concatenate([idx[1:], [-1]])], axis=1)


def assemble_drift(out, pos, sigma, cfg: SamplerConfig):
    """eps_pos from a model output: the local branch (optionally clipped)
    plus the global branch, gated on once sigma < global_start_sigma.
    `sigma` is a scalar (the ladder's level) or (B,), one per graph (the
    distillation loss trains every ladder level in one batch,
    train/distill.py; agdiff_tpu/sampling/langevin.py:127-131)."""
    node_eq_local = eq_transform_dense(out.edge_inv_local, pos,
                                       out.local_mask, out.edge_length)
    if cfg.clip_local is not None:
        node_eq_local = clip_norm(node_eq_local, cfg.clip_local)
    inv_global = out.edge_inv_global * (1.0 - out.local_mask.float())
    node_eq_global = clip_norm(
        eq_transform_dense(inv_global, pos, out.edge_mask, out.edge_length),
        cfg.clip)
    # where, not multiply-by-zero: an inactive branch never injects NaN
    gate = sigma < cfg.global_start_sigma
    if gate.dim():
        gate = gate[:, None, None]
    node_eq_global = torch.where(gate, node_eq_global,
                                 torch.zeros_like(node_eq_global))
    return node_eq_local + node_eq_global * cfg.w_global


class Ladder:
    """One ladder's state and step function on the batch's device.

    The batch's fields are copied into tensors of the ladder's own
    (`load`), so that a captured graph reads the same memory on every
    run. `plan` lists the blocks: ('ladder', S, first step, keep pos
    after) and ('tail', S, ...). The table holds the ladder's rows, then
    the tail's (the last level twice); j = -1 is stored as T, where the
    sigma table holds 0 and the alpha table 1, JAX's values at j = -1.
    """

    def __init__(self, forward_fn: Callable, batch, diffusion: Diffusion,
                 config: SamplerConfig, pairs=None,
                 shard: Optional[Tuple[slice, int]] = None):
        validate(config)
        cfg = self.config = config
        self.forward_fn, self.pairs = forward_fn, pairs
        dev = batch.pos.device
        t = self.num_timesteps = diffusion.num_timesteps
        rows = ladder_table(t, cfg.n_steps, cfg.ladder)
        last = rows[-1, 0]
        rows = np.concatenate([rows, np.full((cfg.denoise_tail, 2), last)])
        rows[rows < 0] = t
        self.table = torch.as_tensor(rows, dtype=torch.int64, device=dev)
        self.sigmas = torch.cat([
            torch.as_tensor(diffusion.sigmas, dtype=torch.float32),
            torch.zeros(1)]).to(dev)
        self.alphas = torch.cat([
            torch.as_tensor(diffusion.alphas, dtype=torch.float32),
            torch.ones(1)]).to(dev)
        self.batch = batch.replace(**{
            f.name: getattr(batch, f.name).clone()
            for f in dataclasses.fields(batch)})
        self.pos = self.batch.pos
        self.mask3 = self.batch.node_mask[..., None].float()
        self.flags = torch.zeros(batch.num_graphs, dtype=torch.bool,
                                 device=dev)
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self.fwd_kwargs = dict(extend_order=cfg.extend_order,
                               extend_radius=cfg.extend_radius)
        if pairs is not None:
            self.fwd_kwargs["pairs"] = pairs
        self.plan = self._plan()
        size = max([s for kind, s, _, _ in self.plan if kind == "ladder"])
        # shard: (this rank's rows, the global batch's graphs) under a
        # data-parallel group; the draw is the global batch's
        shape = tuple(batch.pos.shape)
        if shard is not None:
            shape = (shard[1],) + shape[1:]
        self.noise_buffer = torch.zeros((size,) + shape, device=dev)
        self.noise = (self.noise_buffer if shard is None
                      else self.noise_buffer[:, shard[0]])
        # a graphed.NodeTally while LadderGraphs captures a block
        self.tally = None

    def _plan(self) -> List[Tuple[str, int, int, bool]]:
        cfg = self.config
        stride = cfg.traj_stride if cfg.traj_stride > 0 else BLOCK_STEPS
        full, rest = divmod(cfg.n_steps, stride)
        plan = [("ladder", stride, k * stride, cfg.traj_stride > 0)
                for k in range(full)]
        if rest:
            plan.append(("ladder", rest, full * stride, False))
        full, rest = divmod(cfg.denoise_tail, BLOCK_STEPS)
        plan += [("tail", BLOCK_STEPS, cfg.n_steps + k * BLOCK_STEPS, False)
                 for k in range(full)]
        if rest:
            plan.append(("tail", rest, cfg.n_steps + full * BLOCK_STEPS,
                         False))
        return plan

    def load(self, batch, pos_init) -> None:
        """Copy the batch in and start the ladder: pos = pos_init *
        sigma_max over real nodes, no flags, step 0."""
        for f in dataclasses.fields(batch):
            if f.name != "pos":
                getattr(self.batch, f.name).copy_(getattr(batch, f.name))
        self.mask3.copy_(self.batch.node_mask[..., None].float())
        self.pos.copy_(pos_init.to(self.pos.device)
                       * self.sigmas[self.num_timesteps - 1] * self.mask3)
        self.flags.zero_()
        self.counter.zero_()

    def eps_at(self, pos, sigma):
        """The assembled drift at positions `pos` and noise level
        `sigma` (a (1,) tensor)."""
        with profiling.span("forward"), \
                self.tally or contextlib.nullcontext():
            out = self.forward_fn(self.batch.replace(pos=pos),
                                  **self.fwd_kwargs)
        return assemble_drift(out, pos, sigma, self.config)

    def step(self, noise: Optional[torch.Tensor], update: str) -> None:
        """One step at the counter's row, in place; `noise` (B, N, 3) or
        None (the tail)."""
        cfg, pos, mask3 = self.config, self.pos, self.mask3
        ij = self.table.index_select(0, self.counter)[0]
        i, j = ij[0:1], ij[1:2]
        sigma_i = self.sigmas.index_select(0, i)
        eps_pos = self.eps_at(pos, sigma_i)
        if update == "generalized":
            a_i = self.alphas.index_select(0, i)
            a_j = self.alphas.index_select(0, j)
            sigma_j = self.sigmas.index_select(0, j)
            sig2_j = sigma_j * sigma_j
            s2 = (cfg.eta ** 2) * sig2_j * (1.0 - a_i / a_j) / (1.0 - a_i)
            s2 = torch.minimum(torch.clamp(s2, min=0.0), sig2_j)
            c_eps = torch.sqrt(sig2_j - s2)
            eps_hat = -eps_pos
            pos_next = pos + (c_eps - sigma_i) * eps_hat
            if cfg.solver == "heun":
                # eta = 0, so pos_next is the Euler predictor; at j = -1
                # the corrected step is computed and selected away
                eps_hat2 = -self.eps_at(pos_next, torch.sqrt(sig2_j))
                pos_heun = pos + (c_eps - sigma_i) * 0.5 * (eps_hat
                                                            + eps_hat2)
                pos_next = torch.where(j < self.num_timesteps, pos_heun,
                                       pos_next)
            if noise is not None:
                pos_next = pos_next + noise * mask3 * torch.sqrt(s2)
        else:
            step_size = cfg.step_lr * (sigma_i / 0.01) ** 2
            pos_next = pos + step_size * eps_pos / sigma_i
            if noise is not None:
                pos_next = pos_next + noise * mask3 * torch.sqrt(
                    step_size * 2.0)
        finite = torch.isfinite(pos_next)
        self.flags |= ~finite.all(dim=2).all(dim=1)
        pos_next = torch.where(finite, pos_next, torch.zeros_like(pos_next))
        pos_next = center_pos(pos_next, self.batch.node_mask)
        if cfg.clip_pos is not None:
            pos_next = torch.clamp(pos_next, -cfg.clip_pos, cfg.clip_pos)
        pos.copy_(pos_next)
        self.counter += 1

    def block(self, kind: str, size: int) -> None:
        """`size` steps from the counter's row: the function a graph
        captures. 'ladder' steps read the noise buffer's first `size`
        entries; 'tail' steps are noise-free 'ld' steps."""
        for s in range(size):
            if kind == "tail":
                self.step(None, "ld")
            else:
                self.step(self.noise[s], self.config.sampling_type)

    def draw(self, size: int, start: int, generator=None,
             noise: Optional[torch.Tensor] = None) -> None:
        """The next ladder block's noise into the buffer: steps [start,
        start + size) of `noise`, else one draw from `generator` (the
        global batch's, under a data-parallel group)."""
        buf = self.noise_buffer[:size]
        if noise is not None:
            buf.copy_(noise[start:start + size])
        else:
            buf.normal_(generator=generator)

    def run(self, generator=None, noise: Optional[torch.Tensor] = None,
            replay: Optional[Callable[[str, int], None]] = None
            ) -> SampleResult:
        """Every block of the plan from the loaded state, each by
        `replay(kind, size)` (a graph) or by `block` (eagerly)."""
        if noise is not None and noise.shape[0] != self.config.n_steps:
            raise ValueError(f"noise has {noise.shape[0]} steps, expected "
                             f"{self.config.n_steps}")
        traj = []
        for kind, size, start, keep in self.plan:
            if kind == "ladder":
                self.draw(size, start, generator, noise)
            (replay or self.block)(kind, size)
            if keep:
                traj.append(self.pos.clone())
        if self.config.traj_stride > 0:
            traj = (torch.stack(traj) if traj else
                    self.pos.new_zeros((0,) + tuple(self.pos.shape)))
        else:
            traj = None
        return SampleResult(self.pos.clone(), self.flags.clone(), traj)


def langevin_dynamics_sample(forward_fn: Callable, batch, pos_init,
                             diffusion: Diffusion, config: SamplerConfig,
                             generator: Optional[torch.Generator] = None,
                             noise: Optional[torch.Tensor] = None,
                             pairs=None, shard=None) -> SampleResult:
    """Run the ladder eagerly. pos_init is standard normal noise (scaled
    here by the largest sigma). The noise comes from `generator`, one draw
    per block, or from `noise` of shape (n_steps, B, N, 3). `pairs`, when
    given, goes to every forward call. `shard` (a data-parallel rank's
    rows, the global batch's graphs): `batch` and pos_init are the rank's
    rows, the noise the global batch's."""
    ladder = Ladder(forward_fn, batch, diffusion, config, pairs, shard)
    ladder.load(batch, pos_init)
    return ladder.run(generator, noise)


class Sampler:
    """run(batch, pos_init, generator=None, noise=None) -> SampleResult
    over a forward. A forward with `prepare` gets its pair list built once
    per ladder (at `pair_capacity` pairs for a tight forward; it must hold
    every graph's real pairs). On a CUDA device the ladder replays CUDA
    graphs (sampling/graphed.py), one set per batch shape and pair list,
    captured at the first run or at `warm`, unless graph=False asks for
    the eager loop; a capture error raises. A tight list is one
    molecule's, and a runner does not come back to a molecule it has
    done, so the sampler keeps the graphs of one tight list per batch
    shape that `warm` did not capture: a new list's capture frees the last
    such list's graphs and their memory. Graphs captured by `warm`
    (`pinned`) stay until `release`: a server warms the classes it serves
    and replays them for every request. The CPU, which has no graphs,
    runs the eager loop. With a data-parallel `group` a run takes the
    global batch and returns every rank's samples (module docstring);
    the graphs are this rank's, of its rows' shape."""

    def __init__(self, forward_fn: Callable, diffusion: Diffusion,
                 config: SamplerConfig, pair_capacity: Optional[int] = None,
                 graph: bool = True, group=None):
        validate(config)
        self.forward_fn, self.diffusion, self.config = (forward_fn,
                                                        diffusion, config)
        self.pair_capacity, self.graph = pair_capacity, graph
        self.group = group
        self.ladders: Dict[tuple, LadderGraphs] = {}
        self.pinned: set = set()   # keys of the graphs `warm` captured

    def pairs(self, batch):
        prepare = getattr(self.forward_fn, "prepare", None)
        if prepare is None:
            return None
        with profiling.span("ladder.pairs"):
            return prepare(batch, self.pair_capacity)

    def graphed(self, batch) -> bool:
        return self.graph and batch.pos.device.type == "cuda"

    def _graphs(self, batch, pairs, pin: bool = False, shard=None
                ) -> Tuple[LadderGraphs, bool]:
        """The graphs of this batch shape and pair list, captured if new
        (and whether they were); pin=True keeps them (`warm`)."""
        key = (tuple(batch.pos.shape), str(batch.pos.device),
               None if pairs is None else pairs.key)
        graphs = self.ladders.get(key)
        new = graphs is None
        if new:
            if pairs is not None and pairs.tight:
                self.release([k for k, g in self.ladders.items()
                              if k[:2] == key[:2] and g.ladder.pairs.tight
                              and k not in self.pinned])
            ladder = Ladder(self.forward_fn, batch, self.diffusion,
                            self.config, pairs, shard)
            graphs = self.ladders[key] = LadderGraphs(ladder, batch)
        if pin:
            self.pinned.add(key)
        return graphs, new

    def release(self, keys=None) -> None:
        """Drop the graphs of `keys` (default: all) and give their memory
        pools back to the device."""
        keys = list(self.ladders) if keys is None else keys
        for k in keys:
            del self.ladders[k]
            self.pinned.discard(k)
        if keys:
            torch.cuda.empty_cache()

    def release_unpinned(self) -> bool:
        """Drop the graphs `warm` did not capture; True when graphs `warm`
        captured are left."""
        self.release([k for k in self.ladders if k not in self.pinned])
        return bool(self.pinned)

    def _shard(self, batch, pos_init=None):
        """(this rank's rows of the global batch and of pos_init, (rows,
        graphs)), or the inputs as they are without a group."""
        if self.group is None:
            return batch, pos_init, None
        b = batch.num_graphs
        rows = self.group.rows(b)
        return (self.group.shard(batch),
                None if pos_init is None else pos_init[rows], (rows, b))

    def warm(self, batch) -> bool:
        """Capture the graphs a run on this batch's shape and pair list
        replays and keep them (`pinned`); False when they exist already
        or the sampler runs eagerly."""
        batch, _, shard = self._shard(batch)
        if not self.graphed(batch):
            return False
        return self._graphs(batch, self.pairs(batch), pin=True,
                            shard=shard)[1]

    @torch.no_grad()
    def __call__(self, batch, pos_init, generator=None,
                 noise: Optional[torch.Tensor] = None) -> SampleResult:
        with profiling.span("ladder.run"):
            batch, pos_init, shard = self._shard(batch, pos_init)
            pairs = self.pairs(batch)
            if not self.graphed(batch):
                out = langevin_dynamics_sample(
                    self.forward_fn, batch, pos_init, self.diffusion,
                    self.config, generator=generator, noise=noise,
                    pairs=pairs, shard=shard)
            else:
                out = self._graphs(batch, pairs, shard=shard)[0].run(
                    batch, pairs, pos_init, generator, noise)
            if self.group is None:
                return out
            g = self.group
            return SampleResult(
                g.gather_rows(out.pos),
                g.gather_rows(out.nan_flags.to(torch.int32)).bool(),
                None if out.traj is None
                else g.gather_rows(out.traj, axis=1))


def build_sampler(model, diffusion: Diffusion, config: SamplerConfig,
                  graph: bool = True, group=None) -> Sampler:
    """A sampler on the dense module path (agdiff_tpu/sampling/langevin.py
    build_sampler): the module in eval mode without gradients; with a
    data-parallel `group`, over its ranks."""
    return Sampler(model.eval(), diffusion, config, graph=graph,
                   group=group)


def build_fast_sampler(forward_fn: Callable, diffusion: Diffusion,
                       config: SamplerConfig,
                       pair_capacity: Optional[int] = None,
                       graph: bool = True, group=None) -> Sampler:
    """A sampler over a folded forward (models/fast_forward.py,
    models/tight_forward.py, models/mono_forward.py); with a
    data-parallel `group`, over its ranks (JAX's mesh argument)."""
    return Sampler(forward_fn, diffusion, config, pair_capacity, graph,
                   group)
