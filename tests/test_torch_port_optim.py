"""The port's optimizer (train/optimizer.py) against the JAX package's
optax chain on the CPU: the same injected gradients (numpy, one tree of
the small model's shapes per step, spread over seven decades so Adam's
moments are exercised far from and near its eps) go through both for five
steps, and the parameters must agree after every step within PARAM_ULPS
float32 ulps of the leaf's largest |p| (the roundings of p + u, which
XLA's fused update and PyTorch's sequence of ops make differently) plus
PARAM_ATOL (Adam moves a parameter by about lr = 1e-3 a step; 1e-6 of
that). Cases: plain, a clip
on every step (max_grad_norm below the gradients' norm), weight decay,
and a non-finite step skipped (skip_nonfinite_updates). Then the
plateau, expmin and expmin_milestone schedules against JAX's, value for
value, and the global/local partition leaf by leaf.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from agdiff_tpu.config import (
    OptimizerConfig as JaxOptimizerConfig,
    SchedulerConfig as JaxSchedulerConfig,
    TrainConfig as JaxTrainConfig,
)
from agdiff_tpu.train import optimizer as jax_opt

from agdiff_torch.config import OptimizerConfig, SchedulerConfig, TrainConfig
from agdiff_torch.models.weights import export_jax_variables, flax_leaf
from agdiff_torch.train import optimizer as port_opt

from test_torch_port_common import batches, configs, jax_variables, \
    molecules, port_model

PARAM_ULPS = 4
PARAM_ATOL = 1e-9
STEPS = 5


@pytest.fixture(scope="module")
def model_setup():
    jcfg, cfg = configs()
    jb, _ = batches(molecules(2, seed=3), 16)
    _, variables = jax_variables(jcfg, jb)
    rng = np.random.default_rng(8)

    def grads_like(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = grads_like(v)
            else:
                scale = 10.0 ** rng.uniform(-6, 1, v.shape)
                out[k] = np.asarray(rng.normal(size=v.shape) * scale,
                                    np.float32)
        return out

    steps = [grads_like(variables["params"]) for _ in range(STEPS)]
    return cfg, variables, steps


def _norm(tree):
    return float(np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2))
                             for g in jax.tree_util.tree_leaves(tree))))


def _set_grads(model, tree):
    for name, p in model.named_parameters():
        _, path = flax_leaf(model, name)
        g = tree
        for k in path:
            g = g[k]
        g = np.asarray(g)
        p.grad = torch.from_numpy(np.array(g.T if path[-1] == "kernel"
                                           else g, order="C"))


CASES = {
    "plain": dict(),
    "clip": dict(max_grad_norm=None),         # set below the norms
    "weight_decay": dict(weight_decay=0.05),
    "skip_nonfinite": dict(skip_nonfinite_updates=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_optax(model_setup, case):
    cfg, variables, steps = model_setup
    steps = [dict(s) for s in steps]
    opt_kw = dict(lr=1e-3, beta1=0.95, beta2=0.999)
    train_kw = dict(max_grad_norm=10000.0)
    if case == "clip":
        norms = [_norm(s) for s in steps]
        train_kw["max_grad_norm"] = 0.25 * min(norms)
    if case == "weight_decay":
        opt_kw["weight_decay"] = 0.05
    if case == "skip_nonfinite":
        train_kw["skip_nonfinite_updates"] = True
        bad = jax.tree_util.tree_map(np.copy, steps[2])
        bad["encoder_local"]["node_emb"]["embedding"][0, 0] = np.nan
        steps[2] = bad
    jax_cfg = JaxTrainConfig(optimizer=JaxOptimizerConfig(**opt_kw),
                             **train_kw)
    tx = jax_opt.make_optimizer(jax_cfg)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    state = tx.init(params)
    update = jax.jit(tx.update)

    model = port_model(cfg, variables)
    opt = port_opt.make_optimizer(
        model, TrainConfig(optimizer=OptimizerConfig(**opt_kw), **train_kw))
    for k, grads in enumerate(steps):
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        _set_grads(model, grads)
        norm = opt.step()
        assert abs(float(norm) - float(optax.global_norm(grads))) <= \
            1e-5 * float(optax.global_norm(grads)) or k == 2 and \
            case == "skip_nonfinite"
        got = export_jax_variables(model)["params"]
        for path, want in jax.tree_util.tree_leaves_with_path(params):
            keys = [p.key for p in path]
            leaf = got
            for key in keys:
                leaf = leaf[key]
            want = np.asarray(want)
            ulp = float(np.abs(want).max()) * np.finfo(np.float32).eps
            np.testing.assert_allclose(leaf, want, rtol=0,
                                       atol=PARAM_ULPS * ulp + PARAM_ATOL,
                                       err_msg=f"{case} step {k} {keys}")
    counts = [opt.adams[n].count for n in (port_opt.GLOBAL, port_opt.LOCAL)]
    assert counts == ([STEPS - 1] * 2 if case == "skip_nonfinite"
                      else [STEPS] * 2)
    if case == "skip_nonfinite":
        assert int(state.notfinite_count) == opt.notfinite_count == 0


def test_skipped_step_changes_nothing(model_setup):
    """A step with a NaN gradient leaves every parameter, both Adams'
    moments and their counts as they were; the next finite step goes on."""
    cfg, variables, steps = model_setup
    model = port_model(cfg, variables)
    opt = port_opt.make_optimizer(
        model, TrainConfig(skip_nonfinite_updates=True))
    _set_grads(model, steps[0])
    opt.step()
    before = [t.clone() for t in model.parameters()]
    moments = [t.clone() for a in opt.adams.values() for t in a.mu + a.nu]
    bad = jax.tree_util.tree_map(np.copy, steps[1])
    bad["grad_global_dist_mlp"]["layers_0"]["bias"][3] = np.inf
    _set_grads(model, bad)
    opt.step()
    assert opt.notfinite_count == 1
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), before))
    assert all(torch.equal(a, b) for a, b in zip(
        [t for a in opt.adams.values() for t in a.mu + a.nu], moments))
    assert [a.count for a in opt.adams.values()] == [1, 1]
    _set_grads(model, steps[1])
    opt.step()
    assert opt.notfinite_count == 0
    assert [a.count for a in opt.adams.values()] == [2, 2]


def test_learning_rates_are_per_partition(model_setup):
    cfg, variables, steps = model_setup
    model = port_model(cfg, variables)
    opt = port_opt.make_optimizer(model, TrainConfig())
    opt.set_learning_rates(1e-3, 0.0)
    assert opt.get_learning_rates() == (1e-3, 0.0)
    before = {n: p.clone() for n, p in model.named_parameters()}
    _set_grads(model, steps[0])
    opt.step()
    labels = port_opt.param_partition(model)
    for name, p in model.named_parameters():
        moved = not torch.equal(p, before[name])
        assert moved == (labels[name] == port_opt.GLOBAL), name


@pytest.mark.parametrize("tied", [True, False])
def test_partition_matches_jax(tied):
    jcfg, cfg = configs(tie_edge_encoders=tied)
    jb, _ = batches(molecules(2, seed=3), 16)
    _, variables = jax_variables(jcfg, jb)
    want = jax_opt.param_partition(variables["params"])
    model = port_model(cfg, variables)
    got = port_opt.param_partition(model)
    assert set(got.values()) == {port_opt.GLOBAL, port_opt.LOCAL}
    for name, label in got.items():
        _, path = flax_leaf(model, name)
        leaf = want
        for k in path:
            leaf = leaf[k]
        assert leaf == label, name
    assert got["edge_encoder_global.bond_emb.weight"] == port_opt.GLOBAL


@pytest.mark.parametrize("kind", ["plateau", "expmin", "expmin_milestone"])
def test_schedules_match_jax(kind):
    """Fifty validations of a noisy, mostly flat metric: the same learning
    rate, best and bad count after each, to the bit."""
    kw = dict(type=kind, factor=0.6, patience=3, min_lr=1e-4, milestone=4)
    jsched, sched = JaxSchedulerConfig(**kw), SchedulerConfig(**kw)
    rng = np.random.default_rng(2)
    metrics = 10.0 + np.cumsum(rng.normal(0, 0.05, 50)) * (
        rng.random(50) < 0.7)
    js, ps = jax_opt.plateau_init(1e-3), port_opt.plateau_init(1e-3)
    lrs = set()
    for m in metrics:
        js = jax_opt.scheduler_step(js, float(m), jsched)
        ps = port_opt.scheduler_step(ps, float(m), sched)
        assert dataclasses.asdict(ps) == dataclasses.asdict(js)
        lrs.add(ps.lr)
    assert len(lrs) > 2 and min(lrs) >= 1e-4
