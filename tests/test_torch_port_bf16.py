"""The module path at bf16 compute against the JAX package on the CPU:
the port's module at `dtype: bfloat16` against JAX's `apply(train=False)`
(dense and packed_pairs), the dense-module runner (no --fast) at a bf16
config against JAX's `build_sampler` (the ladder of its runner with
use_fast=False) on strided DDIM at eta 0, the bf16 train step's loss,
every gradient leaf and the running statistics against JAX's bf16
`value_and_grad` (dense and packed_pairs, injected t and noise), five
optimizer steps against JAX's optax chain, remat against none, and
`cli.train` and `cli.generate` on a tiny bf16 config.

The JAX references compile with `xla_allow_excess_precision` off: XLA's
CPU backend otherwise keeps f32 where the program states a bf16 rounding
(its bf16 distances come out unrounded, ROADMAP.md reference-side
defects). bf16 results are held at stated limits, never for bit
equality:

  * score planes on their masks: max |diff| <= SCORE_REL x the plane's
    largest |value| (two bf16 ulps there);
  * edge lengths: bf16 values (the distances are taken at bf16), within
    one bf16 ulp of JAX's;
  * the runner's positions after eight steps: max |diff| <= POS_REL x
    the largest |pos| (read 8.6e-5; the f32 module, 7.7e-3);
  * losses: relative LOSS_RTOL (read 5e-5; the f32 module 4e-2); running
    statistics: STATS_RTOL of max(the statistic's magnitude, 1) (read
    2e-4; the f32 module 4e-3);
  * gradients, leaf by leaf: max |diff| <= GRAD_TOP_REL x the largest |g|
    of the model (read 1.4e-2 dense, 2.9e-2 packed; the f32 module 0.47
    and 0.32), and over the leaves the median of |diff| / |g| (L2 norms)
    <= GRAD_MEDIAN (read 4.8e-2 and 4.4e-2; the f32 module 0.12 and
    0.087): bf16 sums of many terms put single elements of some leaves
    (biases ahead of a BatchNorm, whose true gradient is 0) far off in
    relative terms in both packages;
  * five Adam steps (lr = 1e-3): after step k (from 0) each step's loss
    within STEP_LOSS_RTOL (read 5.8e-5 to 2.7e-3; the f32 module
    2.9e-3 to 0.17), at most (k + 1) x OFF_SHARE of the parameter elements
    off JAX's by more than lr / 2 (read 0.013 to 0.079; the f32 module
    0.070 to 0.236) and the median |diff| at most (k + 1) x OFF_MEDIAN
    (read 0 to 5.3e-5; the f32 module up to 1.4e-4). The first Adam step
    moves every element by lr x the sign of its gradient, so an element
    whose gradient is rounding noise in both packages may move the other
    way: an element-wise limit would hold nothing.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from agdiff_tpu.config import (
    OptimizerConfig as JaxOptimizerConfig,
    TrainConfig as JaxTrainConfig,
)
from agdiff_tpu.models.dualenc import get_model as jax_get_model
from agdiff_tpu.models.loss import diffusion_loss as jax_diffusion_loss
from agdiff_tpu.models.schedules import make_diffusion as jax_diffusion
from agdiff_tpu.sampling.langevin import (
    SamplerConfig as JaxSamplerConfig,
    build_sampler as jax_build_sampler,
)
from agdiff_tpu.train import optimizer as jax_opt

from agdiff_torch.cli import generate as gen_cli
from agdiff_torch.cli import train as train_cli
from agdiff_torch.config import OptimizerConfig, TrainConfig
from agdiff_torch.eval import generate as port_generate
from agdiff_torch.eval.generate import MODULE, GenerationRunner, load_samples
from agdiff_torch.models.loss import diffusion_loss, perturb_positions
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.models.weights import export_jax_variables, flax_leaf
from agdiff_torch.sampling.langevin import SamplerConfig
from agdiff_torch.train import optimizer as port_opt

from test_torch_port_common import (
    FAST_XLA,
    SMALL,
    batches,
    configs,
    jax_variables,
    molecules,
    port_model,
)

NARROW_XLA = {**FAST_XLA, "xla_allow_excess_precision": False}
SCORE_REL = 2 ** -6
POS_REL = 1e-3
LOSS_RTOL = 1e-3
STATS_RTOL = 1e-3
GRAD_TOP_REL = 6e-2
GRAD_MEDIAN = 7e-2
STEP_LOSS_RTOL = 5e-3
OFF_SHARE = 0.025
OFF_MEDIAN = 2e-5
B, N = 4, 16
RUNNER_STEPS = 8
OPT_STEPS = 5
SYNTH = ["--synthetic", "16", "--synthetic_heavy", "5", "--device", "cpu"]


def jax_narrow(fn, *args):
    """fn(*args) compiled as one program that keeps every bf16 rounding
    it states."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=NARROW_XLA)(*args)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _inputs(packed=False):
    jcfg, cfg = configs(dtype="bfloat16", packed_pairs=packed)
    jb, tb = batches(molecules(3, seed=5), N, batch_size=B)
    rng = np.random.default_rng(17)
    t = rng.integers(0, jcfg.num_diffusion_timesteps, B)
    noise = rng.normal(size=(B, N, 3)).astype(np.float32)
    return jcfg, cfg, jb, tb, t, noise


def _loss_fn(jcfg):
    """JAX's train-step loss with t and the noise injected
    (agdiff_tpu/train/train_step.py:73-86)."""
    model = jax_get_model(jcfg)
    alphas = jnp.asarray(jax_diffusion(jcfg).alphas)

    def loss_fn(params, batch_stats, batch, t, noise):
        a = alphas[t]
        pos_p = batch.pos + noise * batch.node_mask[..., None] * (
            jnp.sqrt(1.0 - a) / jnp.sqrt(a))[:, None, None]
        out, mut = model.apply(
            {"params": params, "batch_stats": batch_stats},
            batch.replace(pos=pos_p), train=True, mutable=["batch_stats"])
        lo = jax_diffusion_loss(out, batch, pos_p, a, jcfg.cutoff)
        return lo.loss, (lo, mut["batch_stats"])

    return loss_fn


def port_train_step(cfg, variables, tb, t, noise):
    model = port_model(cfg, variables)
    alphas = torch.as_tensor(make_diffusion(cfg).alphas)
    pos_p, a = perturb_positions(tb, alphas, torch.as_tensor(t),
                                 torch.as_tensor(noise))
    lo = diffusion_loss(model(tb.replace(pos=pos_p), train=True), tb,
                        pos_p, a, cfg.cutoff)
    lo.loss.backward()
    return model, lo


# ---- the module ------------------------------------------------------------


@pytest.fixture(scope="module", params=[False, True],
                ids=["dense", "packed"])
def forward_case(request):
    jcfg, cfg, jb, tb, _, _ = _inputs(request.param)
    model, variables = jax_variables(jcfg, jb)
    want = jax_narrow(lambda v, b: model.apply(v, b, train=False),
                      variables, jb)
    with torch.no_grad():
        got = port_model(cfg, variables)(tb)
    return want, got


def test_module_at_bf16_matches_jax(forward_case):
    want, got = forward_case
    for name, mask in (("edge_inv_global", "edge_mask"),
                       ("edge_inv_local", "local_mask")):
        m = np.asarray(getattr(want, mask))
        np.testing.assert_array_equal(getattr(got, mask).numpy(), m)
        w = np.asarray(getattr(want, name))
        g = getattr(got, name)
        assert g.dtype == torch.float32
        scale = float(np.abs(w[m]).max())
        assert scale > 1e-2, name
        err = float(np.abs(g.numpy() - w)[m].max())
        assert err <= SCORE_REL * scale, f"{name}: {err:.3e}"


def test_module_at_bf16_takes_bf16_distances(forward_case):
    """The positions are cast to bf16 before the distances, as in the
    JAX module: every edge length is a bf16 value (an f32 module gives
    f32 distances), within one bf16 ulp of JAX's."""
    want, got = forward_case
    m = np.asarray(want.edge_mask)
    el = got.edge_length
    assert torch.equal(el, el.bfloat16().float())
    w = np.asarray(want.edge_length)
    ulp = np.abs(w) * 2.0 ** -7
    assert (np.abs(el.numpy() - w)[m] <= ulp[m]).all()
    np.testing.assert_array_equal(got.edge_type.numpy(),
                                  np.asarray(want.edge_type))


def test_module_runner_at_bf16_matches_jax():
    """GenerationRunner without use_fast at a bf16 config samples the bf16
    module (MODULE), as JAX's runner with use_fast=False samples
    `build_sampler(model)` at the config's dtype: the same start, eight
    strided DDIM steps at eta 0."""
    jcfg, cfg, jb, tb, _, _ = _inputs()
    model, variables = jax_variables(jcfg, jb)
    kw = dict(n_steps=RUNNER_STEPS, ladder="strided",
              sampling_type="generalized", eta=0.0, w_global=0.3,
              clip_local=20.0)
    pos_init = np.random.default_rng(4).normal(
        size=(B, N, 3)).astype(np.float32)
    jrun = jax_build_sampler(model, jax_diffusion(jcfg),
                             JaxSamplerConfig(**kw))
    want = np.asarray(jrun.lower(variables, jb, jnp.asarray(pos_init),
                                 jax.random.PRNGKey(0)).compile(
        compiler_options=NARROW_XLA)(
        variables, jb, jnp.asarray(pos_init), jax.random.PRNGKey(0)).pos)

    runner = GenerationRunner(port_model(cfg, variables), cfg,
                              make_diffusion(cfg), SamplerConfig(**kw),
                              buckets=(N,), chunk_size=B, device="cpu",
                              use_fast=False)
    assert runner._engine_for(N) == MODULE
    assert runner.forward(MODULE).compute_dtype == torch.bfloat16
    got = runner._sampler(MODULE, False)(
        tb, torch.from_numpy(pos_init)).pos.numpy()
    real = np.asarray(jb.node_mask)
    scale = float(np.abs(want[real]).max())
    assert scale > 0.5
    err = float(np.abs(got - want)[real].max())
    assert err <= POS_REL * scale, err


# ---- training --------------------------------------------------------------


@pytest.fixture(scope="module", params=[False, True],
                ids=["dense", "packed"])
def train_case(request):
    jcfg, cfg, jb, tb, t, noise = _inputs(request.param)
    _, variables = jax_variables(jcfg, jb)
    loss_fn = _loss_fn(jcfg)
    (_, (lo, stats)), grads = jax_narrow(
        lambda p, s, b, t, n: jax.value_and_grad(loss_fn, has_aux=True)(
            p, s, b, t, n),
        variables["params"], variables["batch_stats"], jb,
        jnp.asarray(t, jnp.int32), jnp.asarray(noise))
    model, port_lo = port_train_step(cfg, variables, tb, t, noise)
    return dict(variables=variables, jax=(lo, stats, grads),
                port=(model, port_lo))


def test_bf16_train_loss_matches_jax(train_case):
    lo_j = train_case["jax"][0]
    lo = train_case["port"][1]
    for name in ("loss", "loss_global", "loss_local"):
        want = float(getattr(lo_j, name))
        got = float(getattr(lo, name).detach())
        assert want > 0.0, name
        assert abs(got - want) <= LOSS_RTOL * want, (name, got, want)


def test_bf16_every_gradient_leaf_matches_jax(train_case):
    grads = train_case["jax"][2]
    model = train_case["port"][0]
    top = max(float(np.abs(g).max())
              for g in jax.tree_util.tree_leaves(grads))
    assert top > 0.0
    norm_rel = []
    for name, p in model.named_parameters():
        _, path = flax_leaf(model, name)
        want = _leaf(grads, path)
        got = p.grad.numpy()
        assert p.grad.dtype == torch.float32, name
        if path[-1] == "kernel":
            got = got.T
        err = float(np.abs(got - want).max())
        assert err <= GRAD_TOP_REL * top, f"{name}: {err:.3e}"
        norm_rel.append(np.linalg.norm(got - want)
                        / max(np.linalg.norm(want), 1e-30))
    assert len(norm_rel) == len(jax.tree_util.tree_leaves(grads))
    assert float(np.median(norm_rel)) <= GRAD_MEDIAN, np.median(norm_rel)


def test_bf16_running_statistics_match_jax(train_case):
    stats = train_case["jax"][1]
    model = train_case["port"][0]
    moved = 0
    for name, buf in model.named_buffers():
        _, path = flax_leaf(model, name)
        want = _leaf(stats, path)
        before = _leaf(train_case["variables"]["batch_stats"], path)
        assert buf.dtype == torch.float32, name
        moved += not np.array_equal(want, before)
        tol = STATS_RTOL * max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(buf.numpy(), want, rtol=0, atol=tol,
                                   err_msg=name)
    assert moved > 0


def test_bf16_remat_equals_plain_and_moves_statistics_once():
    """config.remat at bf16: the same loss, gradients and running
    statistics as without it, bit for bit (the recomputation in backward
    casts as the forward did and leaves the statistics alone)."""
    jcfg, cfg, jb, tb, t, noise = _inputs(packed=True)
    _, variables = jax_variables(jcfg, jb)
    torch.use_deterministic_algorithms(True)
    try:
        plain, lo = port_train_step(cfg, variables, tb, t, noise)
        remat, lo_r = port_train_step(dataclasses.replace(cfg, remat=True),
                                      variables, tb, t, noise)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(lo_r.loss, lo.loss)
    for (name, a), (_, b) in zip(plain.named_parameters(),
                                 remat.named_parameters()):
        assert torch.equal(a.grad, b.grad), name
    moved = 0
    for (name, a), (_, b) in zip(plain.named_buffers(),
                                 remat.named_buffers()):
        assert torch.equal(a, b), name
        moved += not np.array_equal(
            a.numpy(), _leaf(variables["batch_stats"],
                             flax_leaf(plain, name)[1]))
    assert moved > 0


def test_bf16_five_optimizer_steps_match_optax():
    """Five bf16 train steps, each with its own injected t and noise,
    through the clip and the two Adams: the parameters after each step
    against JAX's value_and_grad + optax chain on the same inputs."""
    jcfg, cfg, jb, tb, _, _ = _inputs()
    _, variables = jax_variables(jcfg, jb)
    rng = np.random.default_rng(23)
    draws = [(rng.integers(0, jcfg.num_diffusion_timesteps, B),
              rng.normal(size=(B, N, 3)).astype(np.float32))
             for _ in range(OPT_STEPS)]
    opt_kw = dict(lr=1e-3, beta1=0.95, beta2=0.999)
    tx = jax_opt.make_optimizer(JaxTrainConfig(
        optimizer=JaxOptimizerConfig(**opt_kw), max_grad_norm=10000.0))
    loss_fn = _loss_fn(jcfg)

    def jstep(params, stats, opt_state, batch, t, noise):
        (loss, (_, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, stats, batch, t, noise)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, loss

    params = variables["params"]
    stats = variables["batch_stats"]
    opt_state = tx.init(params)
    args = (params, stats, opt_state, jb, jnp.asarray(draws[0][0], jnp.int32),
            jnp.asarray(draws[0][1]))
    compiled = jax.jit(jstep).lower(*args).compile(
        compiler_options=NARROW_XLA)

    model = port_model(cfg, variables)
    opt = port_opt.make_optimizer(model, TrainConfig(
        optimizer=OptimizerConfig(**opt_kw), max_grad_norm=10000.0))
    alphas = torch.as_tensor(make_diffusion(cfg).alphas)
    for k, (t, noise) in enumerate(draws):
        params, stats, opt_state, want_loss = compiled(
            params, stats, opt_state, jb, jnp.asarray(t, jnp.int32),
            jnp.asarray(noise))
        pos_p, a = perturb_positions(tb, alphas, torch.as_tensor(t),
                                     torch.as_tensor(noise))
        lo = diffusion_loss(model(tb.replace(pos=pos_p), train=True), tb,
                            pos_p, a, cfg.cutoff)
        opt.zero_grad()
        lo.loss.backward()
        opt.step()
        assert abs(float(lo.loss) - float(want_loss)) <= \
            STEP_LOSS_RTOL * float(want_loss), k
        got = export_jax_variables(model)
        off = np.concatenate([
            np.abs(_leaf(got["params"], [p.key for p in path])
                   - np.asarray(want)).ravel()
            for path, want in jax.tree_util.tree_leaves_with_path(params)])
        assert float((off > 0.5 * opt_kw["lr"]).mean()) <= \
            OFF_SHARE * (k + 1), k
        assert float(np.median(off)) <= OFF_MEDIAN * (k + 1), k
    assert opt.adams[port_opt.GLOBAL].count == OPT_STEPS


# ---- the CLIs --------------------------------------------------------------


def _bf16_config(path):
    raw = {"model": {**SMALL, "dtype": "bfloat16", "packed_pairs": True},
           "train": {"seed": 3, "batch_size": 4, "val_freq": 3,
                     "max_iters": 6, "ema_decay": 0.9, "step_chunk": 2},
           "buckets": {"max_nodes": [16]}}
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


def test_cli_train_at_bf16_and_generate_without_fast(tmp_path, monkeypatch):
    """cli.train on a bf16 config (packed_pairs, EMA, step_chunk 2): the
    loss is finite and the checkpoint carries the bf16 config; then
    cli.generate on the log dir without --fast samples the bf16 module,
    and with --dtype float32 the f32 one, with other samples."""
    trainer = train_cli.main([_bf16_config(tmp_path / "bf16.yml"),
                              "--logdir", str(tmp_path / "logs"), *SYNTH])
    assert trainer.state.module.compute_dtype == torch.bfloat16
    assert np.isfinite(trainer.losses).all() and len(trainer.losses) == 6
    seen = []
    real_init = port_generate.GenerationRunner.__init__

    def spy(self, model, *a, **kw):
        seen.append(model.compute_dtype)
        real_init(self, model, *a, **kw)

    monkeypatch.setattr(port_generate.GenerationRunner, "__init__", spy)
    samples = {}
    for dtype in ("bfloat16", "float32"):
        out = str(tmp_path / dtype)
        gen_cli.main([trainer.log_dir, "--synthetic", "1",
                      "--synthetic_heavy", "4", "--n_steps", "3",
                      "--ladder", "strided", "--sampling_type",
                      "generalized", "--eta", "0", "--num_confs", "2",
                      "--dtype", dtype, "--out_dir", out, "--device",
                      "cpu"])
        (mol,) = load_samples(os.path.join(out, "samples_all.npz"))
        samples[dtype] = mol.meta["pos_gen"]
    assert seen == [torch.bfloat16, torch.float32]
    a, b = samples["bfloat16"], samples["float32"]
    assert a.shape == b.shape and np.isfinite(a).all()
    assert not np.array_equal(a, b)


def test_dtype_override_rebuilds_the_module(tmp_path):
    """load_inference_bundle's dtype is the module's compute dtype too:
    the same parameters and statistics, another compute dtype."""
    from agdiff_torch.cli._common import load_inference_bundle

    trainer = train_cli.main([_bf16_config(tmp_path / "bf16.yml"),
                              "--logdir", str(tmp_path / "logs"),
                              "--max_iters", "3", *SYNTH])
    cfg16, m16, _, _ = load_inference_bundle(trainer.log_dir)
    cfg32, m32, _, _ = load_inference_bundle(trainer.log_dir,
                                             dtype="float32")
    assert cfg16.model.dtype == "bfloat16" and m16.compute_dtype == \
        torch.bfloat16
    assert cfg32.model.dtype == "float32" and m32.compute_dtype == \
        torch.float32
    assert dataclasses.replace(cfg32.model, dtype="bfloat16") == cfg16.model
    s16, s32 = m16.state_dict(), m32.state_dict()
    assert s16.keys() == s32.keys()
    assert all(torch.equal(s16[k], s32[k]) for k in s16)
