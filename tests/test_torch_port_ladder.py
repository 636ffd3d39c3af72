"""The port's sampler modes against the JAX sampler with JAX's noise
replayed: the strided ladder with DDIM ('generalized') at eta 1 and 0,
Heun, the denoise tail and the trajectory, on the small model (hidden 32,
2 + 2 convs, a 100-step schedule). Also the strided table against JAX's,
the config's refusals, and the block-stepped function that a CUDA graph
captures, run eagerly, against the per-step loop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agdiff_tpu.models.fast_forward import build_fast_forward as jax_fast
from agdiff_tpu.models.schedules import make_diffusion as jax_diffusion
from agdiff_tpu.sampling.langevin import (
    SamplerConfig as JaxSamplerConfig,
    langevin_dynamics_sample,
)

from agdiff_torch.models.fast_forward import build_fast_forward
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.sampling import langevin
from agdiff_torch.sampling.langevin import (
    Ladder,
    SamplerConfig,
    build_fast_sampler,
    ladder_indices,
    ladder_table,
    langevin_dynamics_sample as port_ld,
)

from test_torch_port_common import (
    batches,
    configs,
    jax_run,
    jax_variables,
    molecules,
    port_model,
)

# clipped drifts and the global branch on from the start, as the 'ld'
# ladder test in test_torch_port_sampler.py runs them
BASE = dict(step_lr=2e-4, w_global=0.3, global_start_sigma=10.0, clip=5.0,
            clip_local=4.0)
CASES = {
    "ddim_eta1": dict(n_steps=7, ladder="strided",
                      sampling_type="generalized", eta=1.0),
    "ddim_eta0": dict(n_steps=7, ladder="strided",
                      sampling_type="generalized", eta=0.0),
    "heun": dict(n_steps=5, ladder="strided", sampling_type="generalized",
                 eta=0.0, solver="heun"),
    "ld_tail": dict(n_steps=6, denoise_tail=3),
    "traj": dict(n_steps=8, traj_stride=3),
}


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = configs()
    jb, tb = batches(molecules(3, seed=8), batch_size=4)
    _, variables = jax_variables(jcfg, jb)
    fwd = build_fast_forward(cfg, port_model(cfg, variables), None)
    pos_init = np.random.default_rng(2).normal(
        size=tb.pos.shape).astype(np.float32)
    return jcfg, cfg, jb, tb, variables, fwd, pos_init


def _jax_noise(key, steps, shape):
    """The noise JAX's ladder draws: key, noise_key = split(key) each step,
    then normal(noise_key)."""
    out = []
    for _ in range(steps):
        key, noise_key = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(noise_key, shape,
                                                jnp.float32)))
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("case", list(CASES))
def test_sampler_mode_matches_jax_with_replayed_noise(setup, case):
    jcfg, cfg, jb, tb, variables, fwd, pos_init = setup
    kw = {**BASE, **CASES[case]}
    key = jax.random.PRNGKey(5)
    jfwd = jax_fast(jcfg, variables, use_pallas=False)
    ref = jax_run(lambda b, p, k: langevin_dynamics_sample(
        None, None, b, p, k, jax_diffusion(jcfg), JaxSamplerConfig(**kw),
        forward_fn=jfwd), jb, jnp.asarray(pos_init), key)
    calls0 = fwd.calls
    got = port_ld(fwd, tb, torch.from_numpy(pos_init), make_diffusion(cfg),
                  SamplerConfig(**kw),
                  noise=_jax_noise(key, kw["n_steps"], tb.pos.shape))
    per_step = 2 if kw.get("solver") == "heun" else 1
    assert fwd.calls - calls0 == (kw["n_steps"] * per_step
                                  + kw.get("denoise_tail", 0))
    start = pos_init * make_diffusion(cfg).sigmas[-1] \
        * tb.node_mask.numpy()[..., None]
    assert np.abs(np.asarray(ref.pos) - start).max() > 1e-2
    assert np.isfinite(np.asarray(ref.pos)).all()
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               atol=1e-4)
    np.testing.assert_array_equal(got.nan_flags.numpy(),
                                  np.asarray(ref.nan_flags))
    if case == "traj":
        # 8 // 3 = 2 entries; the two steps left over run after the last
        assert ref.traj.shape == (2,) + tuple(tb.pos.shape)
        assert got.traj.shape == ref.traj.shape
        np.testing.assert_allclose(got.traj.numpy(), np.asarray(ref.traj),
                                   atol=1e-4)
        assert not np.allclose(np.asarray(ref.traj[-1]),
                               np.asarray(ref.pos))
    else:
        assert got.traj is None and ref.traj is None


@pytest.mark.parametrize("t,n", [(100, 7), (100, 33), (5000, 16),
                                 (5000, 100)])
def test_strided_table_matches_jax(t, n):
    def jax_steps():
        # agdiff_tpu/sampling/langevin.py:247-258
        indices = jnp.round(jnp.linspace(t - 1, 0, n)).astype(jnp.int32)
        return jnp.stack([indices, jnp.concatenate(
            [indices[1:], jnp.full((1,), -1, indices.dtype)])], axis=1)

    want = np.asarray(jax.jit(jax_steps)())
    np.testing.assert_array_equal(ladder_table(t, n, "strided"), want)
    np.testing.assert_array_equal(ladder_indices(t, n, "strided"),
                                  want[:, 0])
    np.testing.assert_array_equal(
        ladder_table(t, min(n, t), "suffix")[:, 0],
        np.arange(t - 1, t - min(n, t) - 1, -1))


@pytest.mark.parametrize("kw,match", [
    (dict(sampling_type="ddpm"), "sampling_type"),
    (dict(solver="rk4"), "solver"),
    (dict(sampling_type="generalized", solver="heun", eta=0.5), "eta=0"),
])
def test_config_refusals(setup, kw, match):
    _, cfg, _, tb, _, fwd, pos_init = setup
    with pytest.raises(ValueError, match=match):
        port_ld(fwd, tb, torch.from_numpy(pos_init), make_diffusion(cfg),
                SamplerConfig(n_steps=2, **kw))
    with pytest.raises(ValueError, match=match):
        build_fast_sampler(fwd, make_diffusion(cfg),
                           SamplerConfig(n_steps=2, **kw))


@pytest.mark.parametrize("case", ["ddim_eta1", "heun", "ld_tail", "traj"])
def test_blocks_equal_the_per_step_loop(setup, case, monkeypatch):
    """The block-stepped function a graph captures, run eagerly, gives
    the bits of one step at a time, whatever the block size."""
    _, cfg, _, tb, _, fwd, pos_init = setup
    config = SamplerConfig(**{**BASE, **CASES[case]})
    diffusion = make_diffusion(cfg)
    noise = torch.randn((config.n_steps,) + tuple(tb.pos.shape),
                        generator=torch.Generator().manual_seed(3))
    pos0 = torch.from_numpy(pos_init)
    runs = []
    for block in (langevin.BLOCK_STEPS, 2):
        monkeypatch.setattr(langevin, "BLOCK_STEPS", block)
        runs.append(port_ld(fwd, tb, pos0, diffusion, config, noise=noise))
    ladder = Ladder(fwd, tb, diffusion, config)
    ladder.load(tb, pos0)
    traj = []
    for k in range(config.n_steps):
        ladder.step(noise[k], config.sampling_type)
        if config.traj_stride and (k + 1) % config.traj_stride == 0:
            traj.append(ladder.pos.clone())
    for _ in range(config.denoise_tail):
        ladder.step(None, "ld")
    for got in runs:
        assert torch.equal(got.pos, ladder.pos)
        assert torch.equal(got.nan_flags, ladder.flags)
        if config.traj_stride:
            assert torch.equal(got.traj, torch.stack(traj))
    # a generator's draws: one (S, B, N, 3) block at a time, eagerly on
    # the CPU, the same bits run to run
    gen = [build_fast_sampler(fwd, diffusion, config)(
        tb, pos0, generator=torch.Generator().manual_seed(4))
        for _ in range(2)]
    assert torch.equal(gen[0].pos, gen[1].pos)


def test_the_cpu_runs_the_eager_loop(setup):
    """The CPU has no graphs: a sampler there runs the eager loop, warm
    captures nothing, and both give the eager function's bits."""
    _, cfg, _, tb, _, fwd, pos_init = setup
    config = dataclasses.replace(SamplerConfig(n_steps=2), unroll=4)
    sampler = build_fast_sampler(fwd, make_diffusion(cfg), config)
    assert sampler.warm(tb) is False
    got = sampler(tb, torch.from_numpy(pos_init),
                  generator=torch.Generator().manual_seed(0))
    assert sampler.ladders == {}
    want = port_ld(fwd, tb, torch.from_numpy(pos_init), make_diffusion(cfg),
                   config, generator=torch.Generator().manual_seed(0),
                   pairs=fwd.prepare(tb))
    assert torch.equal(got.pos, want.pos)
