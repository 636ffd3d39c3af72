"""The port's training forward and loss against the JAX package on the
CPU: train-mode BatchNorm (outputs and running statistics), the diffusion
loss and every gradient leaf of JAX's `model.apply(..., train=True,
mutable=["batch_stats"])` + `diffusion_loss` with injected timesteps and
noise (dense and packed_pairs), packed against dense, remat against none,
and the timestep sampler's antithetic structure.

Tolerances (f32, small model: hidden 32, 2 + 2 convs, bucket 16):
  * losses: relative 1e-5;
  * running statistics: absolute 1e-5;
  * score planes on their masks: 2e-4 (the module path's class);
  * gradients, leaf by leaf: max |diff| <= GRAD_RTOL x the leaf's
    largest |g| + GRAD_FLOOR x the largest |g| of the whole model (the
    floor covers leaves whose true gradient is 0, such as biases ahead of
    a BatchNorm, where both packages return rounding noise).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from agdiff_tpu.models.loss import diffusion_loss as jax_diffusion_loss
from agdiff_tpu.models.schedules import make_diffusion as jax_diffusion
from agdiff_tpu.nn.common import MaskedBatchNorm as JaxBN
from agdiff_tpu.ops.masked import masked_mean as jax_masked_mean

from agdiff_torch.config import Config
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.loss import (
    diffusion_loss,
    perturb_positions,
    sample_timesteps,
)
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.models.weights import flax_leaf, load_jax_variables
from agdiff_torch.nn.common import MaskedBatchNorm
from agdiff_torch.ops.masked import masked_mean
from agdiff_torch.train.train_step import TrainStep

from test_torch_port_common import (
    batches,
    configs,
    jax_run,
    jax_variables,
    molecules,
)

LOSS_RTOL = 1e-5
STATS_ATOL = 1e-5
SCORE_ATOL = 2e-4
GRAD_RTOL = 2e-4
GRAD_FLOOR = 2e-7
B, N = 4, 16


def _inputs():
    """Three molecules in a batch of four (one padding graph), injected
    timesteps and noise."""
    jcfg, cfg = configs()
    jb, tb = batches(molecules(3, seed=5), N, batch_size=B)
    rng = np.random.default_rng(17)
    t = rng.integers(0, jcfg.num_diffusion_timesteps, B)
    noise = rng.normal(size=(B, N, 3)).astype(np.float32)
    return jcfg, cfg, jb, tb, t, noise


def _jax_step(jcfg, variables, jb, t, noise):
    """JAX's train-step loss (agdiff_tpu/train/train_step.py:73-86) with
    t and the noise injected: (loss terms, new batch stats, output,
    gradients)."""
    from agdiff_tpu.models.dualenc import get_model

    model = get_model(jcfg)
    alphas = jnp.asarray(jax_diffusion(jcfg).alphas)

    def loss_fn(params, batch_stats, batch, t, noise):
        a = alphas[t]
        pos_p = batch.pos + noise * batch.node_mask[..., None] * (
            jnp.sqrt(1.0 - a) / jnp.sqrt(a))[:, None, None]
        out, mut = model.apply(
            {"params": params, "batch_stats": batch_stats},
            batch.replace(pos=pos_p), train=True, mutable=["batch_stats"])
        lo = jax_diffusion_loss(out, batch, pos_p, a, jcfg.cutoff)
        return lo.loss, (lo, mut["batch_stats"], out)

    def fn(params, batch_stats, batch, t, noise):
        return jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch_stats, batch, t, noise)

    (_, (lo, stats, out)), grads = jax_run(
        fn, variables["params"], variables["batch_stats"], jb,
        jnp.asarray(t, jnp.int32), jnp.asarray(noise))
    return lo, stats, out, grads


def port_step(cfg, variables, tb, t, noise):
    """The port's loss and gradients on the same inputs: (module after the
    step's forward, loss terms, output)."""
    model = DualEncoderEpsNetwork(cfg)
    load_jax_variables(model, variables)
    alphas = torch.as_tensor(make_diffusion(cfg).alphas)
    pos_p, a = perturb_positions(tb, alphas, torch.as_tensor(t),
                                 torch.as_tensor(noise))
    out = model(tb.replace(pos=pos_p), train=True)
    lo = diffusion_loss(out, tb, pos_p, a, cfg.cutoff)
    lo.loss.backward()
    return model, lo, out


@pytest.fixture(scope="module", params=[False, True],
                ids=["dense", "packed"])
def case(request):
    jcfg, cfg, jb, tb, t, noise = _inputs()
    if request.param:
        jcfg, cfg = configs(packed_pairs=True)
    _, variables = jax_variables(jcfg, jb)
    jax_out = _jax_step(jcfg, variables, jb, t, noise)
    port = port_step(cfg, variables, tb, t, noise)
    return dict(cfg=cfg, variables=variables, tb=tb, t=t, noise=noise,
                jax=jax_out, port=port)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_loss_matches_jax(case):
    lo_j, _, out_j, _ = case["jax"]
    _, lo, out = case["port"]
    for name in ("loss", "loss_global", "loss_local"):
        want = float(getattr(lo_j, name))
        assert want > 0.0, name
        got = float(getattr(lo, name).detach())
        assert abs(got - want) <= LOSS_RTOL * want, name
    np.testing.assert_allclose(lo.per_node.detach().numpy(),
                               np.asarray(lo_j.per_node), rtol=1e-4,
                               atol=1e-4 * float(lo_j.loss))
    for name, mask in (("edge_inv_global", "edge_mask"),
                       ("edge_inv_local", "local_mask")):
        m = np.asarray(getattr(out_j, mask))
        np.testing.assert_array_equal(getattr(out, mask).numpy(), m)
        np.testing.assert_allclose(
            np.where(m, getattr(out, name).detach().numpy(), 0),
            np.where(m, np.asarray(getattr(out_j, name)), 0),
            atol=SCORE_ATOL, err_msg=name)


def test_every_gradient_leaf_matches_jax(case):
    _, _, _, grads = case["jax"]
    model = case["port"][0]
    top = max(float(np.abs(g).max())
              for g in jax.tree_util.tree_leaves(grads))
    assert top > 0.0
    seen = 0
    for name, p in model.named_parameters():
        collection, path = flax_leaf(model, name)
        assert collection == "params"
        want = _leaf(grads, path)
        got = p.grad.numpy()
        if path[-1] == "kernel":
            got = got.T
        tol = GRAD_RTOL * float(np.abs(want).max()) + GRAD_FLOOR * top
        err = float(np.abs(got - want).max())
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"
        seen += 1
    assert seen == len(jax.tree_util.tree_leaves(grads))


def test_running_statistics_match_jax(case):
    _, stats, _, _ = case["jax"]
    model = case["port"][0]
    moved = 0
    for name, buf in model.named_buffers():
        collection, path = flax_leaf(model, name)
        assert collection == "batch_stats"
        want = _leaf(stats, path)
        before = _leaf(case["variables"]["batch_stats"], path)
        moved += not np.array_equal(want, before)
        np.testing.assert_allclose(buf.numpy(), want, atol=STATS_ATOL,
                                   err_msg=name)
    assert moved > 0


def test_packed_layout_equals_dense():
    """One step of the packed_pairs layout against the dense one, the same
    weights and inputs: loss, every gradient and the statistics."""
    jcfg, cfg, jb, tb, t, noise = _inputs()
    _, variables = jax_variables(jcfg, jb)
    dense, lo_d, _ = port_step(cfg, variables, tb, t, noise)
    _, cfg_p = configs(packed_pairs=True)
    packed, lo_p, out_p = port_step(cfg_p, variables, tb, t, noise)
    assert abs(float(lo_p.loss.detach()) - float(lo_d.loss.detach())) <= \
        LOSS_RTOL * float(lo_d.loss.detach())
    assert out_p.edge_inv_global.shape == (B, N, N)
    top = max(float(p.grad.abs().max()) for p in dense.parameters())
    for (name, pd), (_, pp) in zip(dense.named_parameters(),
                                   packed.named_parameters()):
        tol = GRAD_RTOL * float(pd.grad.abs().max()) + GRAD_FLOOR * top
        assert float((pp.grad - pd.grad).abs().max()) <= tol, name
    for (name, bd), (_, bp) in zip(dense.named_buffers(),
                                   packed.named_buffers()):
        torch.testing.assert_close(bp, bd, atol=STATS_ATOL, rtol=0,
                                   msg=name)


def test_remat_equals_plain_and_moves_statistics_once():
    """config.remat recomputes both encoders in backward: the same loss,
    gradients and running statistics as without it, the statistics moved
    once (the recomputation leaves them alone)."""
    torch.use_deterministic_algorithms(True)
    try:
        jcfg, cfg, jb, tb, t, noise = _inputs()
        _, variables = jax_variables(jcfg, jb)
        plain, lo, _ = port_step(cfg, variables, tb, t, noise)
        _, cfg_r = configs(remat=True)
        remat, lo_r, _ = port_step(cfg_r, variables, tb, t, noise)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(lo_r.loss, lo.loss)
    for (name, a), (_, b) in zip(plain.named_parameters(),
                                 remat.named_parameters()):
        assert torch.equal(a.grad, b.grad), name
    for (name, a), (_, b) in zip(plain.named_buffers(),
                                 remat.named_buffers()):
        assert torch.equal(a, b), name


def test_masked_batch_norm_train_matches_jax():
    """One train-mode BatchNorm layer against flax's apply with
    mutable=["batch_stats"]: outputs (zero on padded rows) and running
    statistics, from non-trivial starting statistics."""
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 3.0, (3, 7, 5)).astype(np.float32)
    mask = np.zeros((3, 7), bool)
    mask[0, :7], mask[1, :4], mask[2, :1] = True, True, True
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
                   "bias": rng.normal(size=5).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(size=5).astype(np.float32),
                        "var": rng.uniform(0.5, 2, 5).astype(np.float32)}}
    y_j, mut = JaxBN(5).apply(variables, jnp.asarray(x), jnp.asarray(mask),
                              True, mutable=["batch_stats"])
    bn = MaskedBatchNorm(5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(
            variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(
            variables["batch_stats"]["var"]))
    y = bn(torch.from_numpy(x), torch.from_numpy(mask), train=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=1e-5)
    assert not y[~torch.from_numpy(mask)].any()
    for buf, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(mut["batch_stats"][key]),
                                   atol=STATS_ATOL)
    # eval mode leaves the statistics alone and uses them
    before = bn.running_var.clone()
    y_eval = bn(torch.from_numpy(x), torch.from_numpy(mask))
    y_ej = JaxBN(5).apply({"params": variables["params"],
                           "batch_stats": mut["batch_stats"]},
                          jnp.asarray(x), jnp.asarray(mask), False)
    assert torch.equal(bn.running_var, before)
    np.testing.assert_allclose(y_eval.detach().numpy(), np.asarray(y_ej),
                               atol=1e-5)
    assert isinstance(JaxBN(5), fnn.Module)


def test_masked_mean_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 6, 4)).astype(np.float32)
    mask = rng.random((3, 6)) < 0.6
    for dim in (None, 1):
        want = jax_masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=dim)
        got = masked_mean(torch.from_numpy(x), torch.from_numpy(mask),
                          dim=dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6)


@pytest.mark.parametrize("num_graphs", [1, 4, 7])
def test_sample_timesteps_is_antithetic(num_graphs):
    """num_graphs // 2 + 1 draws in [0, T), then their mirrors T - 1 - t,
    cut to num_graphs; one generator seed gives one draw."""
    T = 100
    gen = torch.Generator().manual_seed(5)
    t = sample_timesteps(gen, num_graphs, T)
    half = num_graphs // 2 + 1
    assert t.shape == (num_graphs,) and t.dtype == torch.int64
    assert bool(((t >= 0) & (t < T)).all())
    mirrored = t[half:]
    assert torch.equal(mirrored, T - 1 - t[:len(mirrored)])
    again = sample_timesteps(torch.Generator().manual_seed(5), num_graphs, T)
    assert torch.equal(t, again)


def test_perturb_positions_keeps_padding_still():
    """The step's own draw: noise from the state's generator, through
    perturb_positions."""
    _, cfg, _, tb, t, _ = _inputs()
    alphas = torch.as_tensor(make_diffusion(cfg).alphas)
    state = SimpleNamespace(generator=torch.Generator().manual_seed(1))
    pos_p, a = TrainStep(Config(model=cfg), "cpu").draws(
        state, tb, torch.as_tensor(t))
    assert torch.equal(a, alphas[torch.as_tensor(t)])
    pad = ~tb.node_mask
    assert torch.equal(pos_p[pad], tb.pos[pad])
    assert not torch.equal(pos_p[~pad], tb.pos[~pad])
