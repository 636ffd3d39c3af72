"""Checkpoints of the JAX package in the port: the JAX package trains and
saves an orbax checkpoint (its own save_checkpoint), the repository's
convert_jax_checkpoint.py adds a state.npz beside it, and the port reads
it without jax (agdiff_torch/train/checkpoint.py), on the CPU.

Held, for a small model (hidden 32, 2 + 2 convs, 50 timesteps, f32, EMA
on, two JAX train steps, the two Adams at different learning rates):

  * the converted state equals JAX's bit for bit: parameters, running
    statistics, each Adam's count, learning rate, mu and nu, the EMA
    shadow, optax.apply_if_finite's count (a run with
    skip_nonfinite_updates) and the step, also for a bf16 run;
  * the eval forward within SCORE_ATOL (2e-4, the module path's class)
    of JAX's on both planes;
  * one further step, resumed, with JAX's t and noise injected, against
    JAX's third step at the sharded tests' limits (loss rtol 1e-5,
    parameters rtol 1e-3 atol 3e-3, moments rtol 2e-3 atol 1e-2; the
    gradient norm rtol 1e-4); at bf16 the loss within the bf16 tests'
    step rtol 5e-3;
  * the committed fixture agdiff_torch/data/fixtures/jax_checkpoint_small
    (made by `python tests/test_torch_port_jax_checkpoint.py
    --write-fixture`, with PYTHONPATH=.:tests) loads, and the port's CPU
    forward and step are held against the JAX numbers stored in it;
  * cli/train.py resumes a converted log dir for 2 iterations and writes
    the port's checkpoint into it, cli/generate.py samples a short ladder
    from it; a directory holding state/ alone raises, naming the
    converter.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from agdiff_tpu.config import (
    Config as JaxConfig,
    config_to_json as jax_config_to_json,
    OptimizerConfig as JaxOptimizerConfig,
    TrainConfig as JaxTrainConfig,
)
from agdiff_tpu.models.loss import sample_timesteps as jax_sample_timesteps
from agdiff_tpu.train.checkpoint import save_checkpoint as jax_save
from agdiff_tpu.train.optimizer import (
    make_optimizer as jax_make_optimizer,
    plateau_init as jax_plateau_init,
    set_learning_rates as jax_set_lrs,
)
from agdiff_tpu.train.train_step import (
    TrainState as JaxTrainState,
    make_train_step as jax_train_step,
)

from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.weights import flax_leaf
from agdiff_torch.parallel import sharded as sh
from agdiff_torch.train.checkpoint import (
    JAX_STATE_FILE,
    latest_checkpoint,
    load_checkpoint,
)
from agdiff_torch.train.optimizer import GLOBAL, LOCAL
from agdiff_torch.train.train_step import create_train_state, make_train_step
from agdiff_torch.train.trainer import restore_state

import convert_jax_checkpoint as converter
from test_torch_port_common import (
    FAST_XLA,
    batches,
    configs,
    jax_run,
    jax_variables,
)
from test_torch_port_sharded import NORM_RTOL, _adam_moments, _broken

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "agdiff_torch", "data", "fixtures",
                       "jax_checkpoint_small")
SCORE_ATOL = 2e-4
BF16_STEP_LOSS_RTOL = 5e-3     # tests/test_torch_port_bf16.py STEP_LOSS_RTOL
B, N = 4, 16
ITER = 2                       # JAX train steps before the checkpoint
LRS = (1e-3, 6e-4)             # the global and the local Adam's
NOTFINITE = 3                  # apply_if_finite's count, set before saving
EMA = 0.999
# the EMA shadow after a step: (1 - EMA) x the parameters' atol (an Adam
# step whose gradient is rounding noise may go either way) plus f32
# rounding of a shadow near 1; a shadow left at the parameters reads
# ~1e-3
EMA_ATOL = (1 - EMA) * 3e-3 + 1e-6
# the fixture's parameter and EMA leaves stored after the JAX step
FIXTURE_LEAVES = ("edge_encoder_global.bond_emb.weight",
                  "encoder_global.interactions_0.conv1.lin1.weight",
                  "encoder_global.interactions_1.lin.bias",
                  "encoder_local.convs_0.nn.layers_0.weight",
                  "grad_global_dist_mlp.layers_2.weight",
                  "grad_local_dist_mlp.layers_0.bias")


def jax_config(dtype="float32", skip=False):
    jcfg, _ = configs(num_diffusion_timesteps=50, dtype=dtype)
    return JaxConfig(model=jcfg, train=JaxTrainConfig(
        batch_size=B, ema_decay=EMA, skip_nonfinite_updates=skip,
        optimizer=JaxOptimizerConfig(lr=LRS[0], beta1=0.95, beta2=0.999),
        seed=3))


def jax_batch():
    from agdiff_tpu.data.synthetic import synthetic_dataset

    return batches(synthetic_dataset(B, seed=5, min_heavy=3, max_heavy=5),
                   N, batch_size=B)


def draws(key, jb, timesteps):
    """The t and noise JAX's train step draws from `key`
    (agdiff_tpu/train/train_step.py loss_fn)."""
    tkey, nkey = jax.random.split(key)
    t = jax_sample_timesteps(tkey, jb.num_graphs, timesteps)
    noise = jax.random.normal(nkey, jb.pos.shape, jb.pos.dtype)
    return (torch.from_numpy(np.array(t)).long(),
            torch.from_numpy(np.array(noise)))


def jax_training_run(log_dir, jconf, grads=False):
    """The JAX package trains ITER steps from jax_variables' weights (the
    Adams at LRS; apply_if_finite's count set to NOTFINITE when it wraps),
    saves checkpoints/ITER with its own save_checkpoint, and takes one
    more step. Returns (model, state saved, batches, (state, metrics[,
    gradients when `grads`]) of the further step, its t and noise)."""
    jb, tb = jax_batch()
    model, variables = jax_variables(jconf.model, jb)
    tx = jax_make_optimizer(jconf.train)
    params = variables["params"]
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=variables["batch_stats"],
        opt_state=jax_set_lrs(tx.init(params), *LRS),
        ema_params=jax.tree_util.tree_map(np.copy, params))
    inner = jax_train_step(model, jconf, jit=False)

    def step_and_grads(state, batch, key):
        new, metrics = inner(state, batch, key)
        if not grads:
            return new, metrics
        # the gradients of the same loss, for the fixture's reference
        from agdiff_tpu.models.loss import diffusion_loss, perturb_positions
        from agdiff_tpu.models.schedules import make_diffusion

        alphas = jnp.asarray(make_diffusion(jconf.model).alphas)

        def loss(params):
            tkey, nkey = jax.random.split(key)
            t = jax_sample_timesteps(tkey, batch.num_graphs,
                                     jconf.model.num_diffusion_timesteps)
            pos_p, a = perturb_positions(nkey, batch, alphas, t)
            out = model.apply({"params": params,
                               "batch_stats": state.batch_stats},
                              batch.replace(pos=pos_p), train=True,
                              mutable=["batch_stats"])[0]
            return diffusion_loss(out, batch, pos_p, a,
                                  jconf.model.cutoff).loss
        return new, metrics, jax.grad(loss)(state.params)

    keys = [jax.random.PRNGKey(k) for k in (11, 12, 13)]
    step = jax.jit(step_and_grads).lower(state, jb, keys[0]).compile(
        compiler_options=FAST_XLA)
    for key in keys[:ITER]:
        state = step(state, jb, key)[0]
    if jconf.train.skip_nonfinite_updates:
        state = state.replace(opt_state=state.opt_state._replace(
            notfinite_count=jnp.asarray(NOTFINITE, jnp.int32)))
    jax_save(log_dir, ITER, jconf, state, jax_plateau_init(LRS[0]),
             jax_plateau_init(LRS[1]), 1234.5, best=True)
    with open(os.path.join(log_dir, "config.yml"), "w") as f:
        yaml.safe_dump(json.loads(jax_config_to_json(jconf)), f)
    further = step(state, jb, keys[ITER])
    t, noise = draws(keys[ITER], jb, jconf.model.num_diffusion_timesteps)
    return model, state, (jb, tb), further, (t, noise)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _flax(module, name, x):
    _, path = flax_leaf(module, name)
    x = x.detach().cpu().numpy()
    return path, (x.T if path[-1] == "kernel" else x)


def _adam_scalars(opt_state):
    """{part: (count, lr)} of a JAX optimizer state."""
    inner = opt_state.inner_state if hasattr(
        opt_state, "notfinite_count") else opt_state
    out = {}
    for part in (GLOBAL, LOCAL):
        injected = inner[1].inner_states[part].inner_state
        out[part] = (int(injected.inner_state[0].count),
                     np.float32(injected.hyperparams["learning_rate"]))
    return out


def _mismatches(payload, state, config) -> list:
    """Every leaf of the port's payload that is not JAX's state's bits."""
    module = DualEncoderEpsNetwork(config.model)
    module.load_state_dict(payload["module"])
    bad = []
    for name, t in list(module.named_parameters()) + list(
            module.named_buffers()):
        coll, path = flax_leaf(module, name)
        _, x = _flax(module, name, t)
        tree = state.params if coll == "params" else state.batch_stats
        if not np.array_equal(x, _leaf(jax.device_get(tree), path)):
            bad.append(name)
    names = {GLOBAL: [], LOCAL: []}
    from agdiff_torch.train.optimizer import param_partition

    labels = param_partition(module)
    for name, _ in module.named_parameters():
        names[labels[name]].append(name)
    moments = _adam_moments(jax.device_get(state.opt_state))
    scalars = _adam_scalars(state.opt_state)
    for part, adam in payload["optimizer"]["adams"].items():
        if (adam["count"], np.float32(adam["lr"])) != scalars[part]:
            bad.append(f"adam {part} count/lr")
        for k, name in enumerate(names[part]):
            path, mu = _flax(module, name, adam["mu"][k])
            _, nu = _flax(module, name, adam["nu"][k])
            want_mu, want_nu = moments[path]
            if not (np.array_equal(mu, want_mu)
                    and np.array_equal(nu, want_nu)):
                bad.append(f"moments {name}")
    ema = jax.device_get(state.ema_params)
    for name, t in payload["ema"].items():
        path, x = _flax(module, name, t)
        if not np.array_equal(x, _leaf(ema, path)):
            bad.append(f"ema {name}")
    want_count = (int(state.opt_state.notfinite_count) if hasattr(
        state.opt_state, "notfinite_count") else 0)
    if payload["optimizer"]["notfinite_count"] != want_count:
        bad.append("notfinite_count")
    if payload["step"] != int(state.step):
        bad.append("step")
    return bad


def port_resumed(path, device="cpu"):
    """A port TrainState resumed from the converted checkpoint `path`, as
    Trainer.resume resumes one: (state, payload)."""
    ckpt = load_checkpoint(path, map_location=device)
    state = create_train_state(ckpt["config"], device)
    restore_state(state, ckpt)
    state.optimizer.set_learning_rates(ckpt["plateau_global"].lr,
                                       ckpt["plateau_local"].lr)
    return state, ckpt


@pytest.fixture(scope="module", params=["f32", "skip", "bf16"])
def run(request, tmp_path_factory):
    """A JAX run of each kind, saved, converted and resumed in the port."""
    jconf = jax_config(dtype="bfloat16" if request.param == "bf16"
                       else "float32", skip=request.param == "skip")
    log_dir = str(tmp_path_factory.mktemp(request.param))
    model, saved, (jb, tb), further, (t, noise) = jax_training_run(
        log_dir, jconf)
    assert converter.main([log_dir]) == 0
    path, it = latest_checkpoint(log_dir)
    state, ckpt = port_resumed(path)
    return dict(kind=request.param, jconf=jconf, model=model, saved=saved,
                jb=jb, tb=tb, further=further, t=t, noise=noise, path=path,
                it=it, state=state, ckpt=ckpt, log_dir=log_dir)


def test_converted_state_is_jax_bit_for_bit(run):
    """Every leaf of the converted payload equals the saved JAX state's:
    parameters, running statistics, each Adam's count, lr, mu and nu, the
    EMA shadow, notfinite_count and the step; the converter adds
    state.npz and changes nothing the JAX package wrote."""
    assert run["it"] == ITER
    assert _mismatches(run["ckpt"], run["saved"], run["ckpt"]["config"]) \
        == []
    assert sorted(os.listdir(run["path"])) == ["meta.json", "state",
                                               JAX_STATE_FILE]
    with open(os.path.join(run["log_dir"], "best_model", "POINTER")) as f:
        assert f.read().strip() == run["path"]
    adams = run["state"].optimizer.adams
    assert adams[GLOBAL].lr == pytest.approx(LRS[0])
    assert adams[LOCAL].lr == pytest.approx(LRS[1])
    assert run["state"].optimizer.notfinite_count == (
        NOTFINITE if run["kind"] == "skip" else 0)


def test_eval_forward_matches_jax(run):
    """The resumed module's eval forward against JAX's on the saved
    variables: both planes within SCORE_ATOL on the working graph (f32),
    or the bf16 module's loss-scale reading (max |diff| within 2% of the
    largest |score|) at bf16."""
    saved = run["saved"]
    want = jax_run(lambda v, b: run["model"].apply(v, b, train=False),
                   {"params": saved.params,
                    "batch_stats": saved.batch_stats}, run["jb"])
    with torch.no_grad():
        got = run["state"].module(run["tb"])
    mask = np.asarray(want.edge_mask)
    for plane in ("edge_inv_global", "edge_inv_local"):
        w = np.asarray(getattr(want, plane), np.float32)[mask]
        g = getattr(got, plane).numpy()[mask]
        if run["kind"] == "bf16":
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), plane
        else:
            np.testing.assert_allclose(g, w, atol=SCORE_ATOL, rtol=0,
                                       err_msg=plane)


def test_resumed_step_matches_jax(run):
    """One step of the resumed port state with JAX's t and noise against
    JAX's further step: the sharded tests' limits on the loss, gradient
    norm, parameters and moments (f32), and apply_if_finite's count
    reset by the finite step; at bf16 the loss within 5e-3."""
    state = run["state"]
    config = run["ckpt"]["config"]
    metrics = make_train_step(config, "cpu")(state, run["tb"], run["t"],
                                             run["noise"])
    new, want = run["further"][0], run["further"][1]
    if run["kind"] == "bf16":
        assert abs(float(metrics.loss) - float(want.loss)) <= \
            BF16_STEP_LOSS_RTOL * abs(float(want.loss))
        return
    got = {"metrics": [float(m) for m in metrics],
           "state": sh.gather_state(state)}
    assert _broken(got, (new, want), DualEncoderEpsNetwork(config.model)) \
        == []
    assert abs(got["metrics"][3] - float(want.grad_norm)) <= \
        NORM_RTOL * float(want.grad_norm)
    assert state.optimizer.notfinite_count == 0
    if run["kind"] == "skip":
        assert int(new.opt_state.notfinite_count) == 0


# ---- the committed fixture ---------------------------------------------------


def fixture_numbers():
    with np.load(os.path.join(FIXTURE, "reference", "jax_numbers.npz")) as z:
        return {k: z[k] for k in z.files}


def fixture_batch(ref):
    from agdiff_torch.data.graph_batch import GraphBatch

    return GraphBatch(**{f: torch.from_numpy(ref[f"batch/{f}"]) for f in (
        "atom_type", "pos", "node_mask", "bond_adj", "graph_mask")})


def test_fixture_loads_and_matches_its_jax_numbers(tmp_path):
    """The committed fixture (a converted JAX log dir) loads; the port's
    CPU forward is within SCORE_ATOL of JAX's stored planes, and one
    resumed step with the stored t and noise within the sharded tests'
    loss and gradient-norm limits of JAX's, its stored parameter and EMA
    leaves within theirs, and every stored gradient leaf within
    test_torch_port_train.py's per-leaf limit."""
    ref = fixture_numbers()
    log_dir = tmp_path / "run"
    shutil.copytree(FIXTURE, log_dir, ignore=shutil.ignore_patterns(
        "reference"))
    path, it = latest_checkpoint(str(log_dir))
    assert it == ITER and not os.path.isdir(os.path.join(path, "state"))
    state, ckpt = port_resumed(path)
    batch = fixture_batch(ref)
    with torch.no_grad():
        out = state.module(batch)
    mask = ref["forward/edge_mask"]
    for plane in ("edge_inv_global", "edge_inv_local"):
        np.testing.assert_allclose(getattr(out, plane).numpy()[mask],
                                   ref[f"forward/{plane}"][mask],
                                   atol=SCORE_ATOL, rtol=0, err_msg=plane)
    metrics = make_train_step(ckpt["config"], "cpu")(
        state, batch, torch.from_numpy(ref["step/t"]),
        torch.from_numpy(ref["step/noise"]))
    for k, name in enumerate(("loss", "loss_global", "loss_local")):
        assert abs(float(metrics[k]) - float(ref[f"step/{name}"])) <= \
            1e-5 * abs(float(ref[f"step/{name}"])), name
    assert abs(float(metrics.grad_norm) - float(ref["step/grad_norm"])) <= \
        NORM_RTOL * float(ref["step/grad_norm"])
    module = state.module
    grads = {n: p.grad for n, p in module.named_parameters()}
    top = max(float(np.abs(ref[k]).max()) for k in ref
              if k.startswith("step/grads/"))
    params = dict(module.named_parameters())
    for name in params:
        path_, g = _flax(module, name, grads[name])
        want = ref["step/grads/" + "/".join(path_)]
        assert np.abs(g - want).max() <= 2e-4 * np.abs(want).max() \
            + 2e-7 * top, name
    for name in FIXTURE_LEAVES:
        path_, p = _flax(module, name, params[name])
        key = "/".join(path_)
        np.testing.assert_allclose(p, ref[f"step/params/{key}"], rtol=1e-3,
                                   atol=3e-3, err_msg=name)
        _, e = _flax(module, name, state.ema[name])
        np.testing.assert_allclose(e, ref[f"step/ema_params/{key}"],
                                   rtol=0, atol=EMA_ATOL, err_msg=name)


# ---- the CLIs ---------------------------------------------------------------


def test_cli_resumes_and_generates_from_a_converted_run(tmp_path):
    """cli/train.py resumes the committed fixture's converted log dir for
    2 iterations (writing the port's checkpoint ITER + 2 into it, finite
    losses), and cli/generate.py samples a 10-step ladder from it on the
    CPU; the same directory holding state/ alone raises, naming the
    converter."""
    from agdiff_torch.cli import generate as gen_cli
    from agdiff_torch.cli import train as train_cli

    log_dir = tmp_path / "run"
    shutil.copytree(FIXTURE, log_dir, ignore=shutil.ignore_patterns(
        "reference"))
    trainer = train_cli.main([str(log_dir), "--max_iters", str(ITER + 2),
                              "--synthetic", "16", "--synthetic_heavy", "5",
                              "--device", "cpu"])
    assert trainer.start_iter == ITER + 1
    assert len(trainer.losses) == 2 and np.isfinite(trainer.losses).all()
    path, it = latest_checkpoint(str(log_dir))
    assert it == ITER + 2
    assert os.path.isfile(os.path.join(path, "state.pt"))
    out = tmp_path / "samples"
    gen_cli.main([os.path.join(str(log_dir), "checkpoints", str(ITER)),
                  "--synthetic", "2", "--n_steps", "10", "--device", "cpu",
                  "--out_dir", str(out)])
    assert any(f.endswith(".npz") for f in os.listdir(out))
    bare = tmp_path / "bare"
    os.makedirs(bare / "checkpoints" / "2" / "state")
    shutil.copy(log_dir / "config.yml", bare / "config.yml")
    with pytest.raises(FileNotFoundError, match="convert_jax_checkpoint.py"):
        train_cli.main([str(bare), "--synthetic", "16", "--device", "cpu"])


# ---- the fixture's maker ------------------------------------------------------


def write_fixture(out=FIXTURE):
    """Make the committed fixture with the JAX package: a JAX run (f32,
    EMA on, 2 steps), converted, its config.yml and checkpoint directory
    without the orbax state/, and JAX's numbers under reference/."""
    import tempfile

    jconf = jax_config()
    with tempfile.TemporaryDirectory() as tmp:
        model, saved, (jb, tb), further, (t, noise) = jax_training_run(
            tmp, jconf, grads=True)
        converter.main([tmp])
        if os.path.isdir(out):
            shutil.rmtree(out)
        ckpt = os.path.join(out, "checkpoints", str(ITER))
        os.makedirs(ckpt)
        os.makedirs(os.path.join(out, "reference"))
        shutil.copy(os.path.join(tmp, "config.yml"), out)
        for name in ("meta.json", JAX_STATE_FILE):
            shutil.copy(os.path.join(tmp, "checkpoints", str(ITER), name),
                        ckpt)
    fwd = model.apply({"params": saved.params,
                       "batch_stats": saved.batch_stats}, jb, train=False)
    new, metrics, grads = further
    module = DualEncoderEpsNetwork(configs(num_diffusion_timesteps=50)[1])
    ref = {f"batch/{f}": np.asarray(getattr(tb, f)) for f in (
        "atom_type", "pos", "node_mask", "bond_adj", "graph_mask")}
    ref.update({"forward/edge_mask": np.asarray(fwd.edge_mask),
                "forward/edge_inv_global": np.asarray(fwd.edge_inv_global),
                "forward/edge_inv_local": np.asarray(fwd.edge_inv_local),
                "step/t": t.numpy(), "step/noise": noise.numpy(),
                "step/grad_norm": np.asarray(metrics.grad_norm)})
    for name in ("loss", "loss_global", "loss_local"):
        ref[f"step/{name}"] = np.asarray(getattr(metrics, name))
    converter._flat("step/grads", jax.device_get(grads), ref)
    for name in FIXTURE_LEAVES:
        _, path = flax_leaf(module, name)
        key = "/".join(path)
        ref[f"step/params/{key}"] = _leaf(jax.device_get(new.params), path)
        ref[f"step/ema_params/{key}"] = _leaf(
            jax.device_get(new.ema_params), path)
    np.savez_compressed(os.path.join(out, "reference", "jax_numbers.npz"),
                        **ref)
    with open(os.path.join(out, "reference", "made_by.json"), "w") as f:
        json.dump({"command": "PYTHONPATH=.:tests python "
                              "tests/test_torch_port_jax_checkpoint.py "
                              "--write-fixture",
                   "jax": jax.__version__}, f, indent=1)


if __name__ == "__main__" and "--write-fixture" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    write_fixture()
