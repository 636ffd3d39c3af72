"""Progressive distillation (agdiff_torch/train/distill.py, cli/distill.py)
against the JAX package's (agdiff_tpu/train/distill.py) on the CPU: the
student grid and its triplets, the per-graph sigma of assemble_drift,
the loss of each weighting and every gradient leaf against JAX's
`make_distill_loss` under `jax.value_and_grad` (k and the noise drawn
with jax.random from the key JAX's loss splits, and injected into the
port), three steps of `make_distill_step`, the chunked step, the eval
step's sums, the teacher and the student's statistics left alone, finite
gradients on padded rows, and the CLI: two stages written, skipped on a
rerun, an interrupted stage resumed, and a stage's student sampled by
cli.generate and served by cli.serve.

Tolerances (f32, small model: hidden 32, 2 + 2 convs, T = 100, bucket 16):
  * losses: relative LOSS_RTOL;
  * gradients, leaf by leaf: max |diff| <= GRAD_RTOL x the leaf's largest
    |g| + GRAD_FLOOR x the largest |g| of the model (tests/
    test_torch_port_train.py's class);
  * parameters after each of three steps (each Adam step moves a
    parameter by about lr = 1e-3; a gradient element that is rounding
    noise in both packages can flip the sign of its first move, so the
    limits are on the share of elements off by more than lr / 2,
    OFF_SHARE, and on the median |diff|, OFF_MEDIAN).
"""

import json
import os
import shutil
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from agdiff_tpu.config import (
    Config as JaxConfig,
    OptimizerConfig as JaxOptimizerConfig,
    TrainConfig as JaxTrainConfig,
)
from agdiff_tpu.models.dualenc import ModelOutput as JaxModelOutput
from agdiff_tpu.sampling.langevin import (
    SamplerConfig as JaxSamplerConfig,
    assemble_drift as jax_assemble_drift,
)
from agdiff_tpu.train import distill as jax_distill
from agdiff_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from agdiff_tpu.train.train_step import TrainState as JaxTrainState

from agdiff_torch.cli import distill as distill_cli
from agdiff_torch.cli import generate as gen_cli
from agdiff_torch.cli import serve as serve_cli
from agdiff_torch.cli import train as train_cli
from agdiff_torch.config import Config, OptimizerConfig, TrainConfig
from agdiff_torch.eval.generate import load_samples
from agdiff_torch.models.dualenc import ModelOutput
from agdiff_torch.models.weights import export_jax_variables, flax_leaf
from agdiff_torch.sampling.langevin import (
    SamplerConfig,
    assemble_drift,
    ladder_indices,
)
from agdiff_torch.serve.server import submit
from agdiff_torch.train import distill

from test_torch_port_common import (
    FAST_XLA,
    SMALL,
    batches,
    configs,
    jax_run,
    jax_variables,
    molecules,
    port_model,
)

LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4
GRAD_FLOOR = 2e-7
OFF_SHARE = 0.02
OFF_MEDIAN = 1e-7
B, N, N_STUDENT = 4, 16, 4
STEPS = 3
SAMPLER = dict(sampling_type="generalized", eta=0.0, ladder="strided",
               w_global=0.3, global_start_sigma=0.5, clip=1000.0,
               clip_local=20.0)
OPT = dict(lr=1e-3, beta1=0.95, beta2=0.999)
SYNTH = ["--synthetic", "16", "--synthetic_heavy", "5", "--device", "cpu"]


# ---- the grid --------------------------------------------------------------


@pytest.mark.parametrize("t,n", [(100, 8), (5000, 8), (5000, 16),
                                 (5000, 32), (5000, 64), (5000, 128)])
def test_grid_and_triplets_equal_jax(t, n):
    np.testing.assert_array_equal(distill.strided_ladder(t, n),
                                  jax_distill.strided_ladder(t, n))
    for got, want in zip(distill.ladder_triplets(t, n),
                         jax_distill.ladder_triplets(t, n)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    start, mid, nxt = distill.ladder_triplets(t, n)
    assert nxt[-1] == -1 and mid[-1] == -1 and start[-1] == 0
    # the distill grid is the sampler's strided grid at these sizes
    np.testing.assert_array_equal(start, ladder_indices(t, n, "strided"))


def test_distill_grid_differs_from_the_sampler_grid_at_143():
    """numpy's float64 linspace (the distill grid, JAX's train/distill.py)
    against XLA's float32 one (the sampler's strided ladder, copied by
    the port): at T = 5000, n = 143 some level rounds the other way
    (a reference-side defect; ROADMAP.md)."""
    grid = distill.strided_ladder(5000, 143)
    assert not np.array_equal(grid, ladder_indices(5000, 143, "strided"))
    np.testing.assert_array_equal(grid, jax_distill.strided_ladder(5000, 143))


# ---- assemble_drift with a per-graph sigma --------------------------------


def _outputs(b, n, rng):
    mask = rng.random((b, n, n)) < 0.6
    mask = mask & mask.transpose(0, 2, 1)
    local = mask & (rng.random((b, n, n)) < 0.5)
    local = local & local.transpose(0, 2, 1)
    length = rng.uniform(0.8, 3.0, (b, n, n)).astype(np.float32)
    length = (length + length.transpose(0, 2, 1)) / 2
    fields = dict(
        edge_inv_global=rng.normal(size=(b, n, n)).astype(np.float32) * 30,
        edge_inv_local=rng.normal(size=(b, n, n)).astype(np.float32) * 30,
        edge_mask=mask, edge_type=np.zeros((b, n, n), np.int32),
        edge_length=length, local_mask=local)
    pos = rng.normal(size=(b, n, 3)).astype(np.float32)
    jax_out = JaxModelOutput(**{k: jnp.asarray(v) for k, v in
                                fields.items()})
    port_out = ModelOutput(**{k: torch.from_numpy(v) for k, v in
                              fields.items()})
    return jax_out, port_out, pos


@pytest.mark.parametrize("b", [3, 4])
def test_assemble_drift_per_graph_sigma_equals_jax(b):
    """A (B,) sigma straddling global_start_sigma (0.5) gates the global
    branch graph by graph, at B = 3 (where broadcasting a (B,) gate over
    (B, N, 3) would have taken the last axis) and B = 4."""
    rng = np.random.default_rng(b)
    jax_out, port_out, pos = _outputs(b, 6, rng)
    sigma = np.array([0.1, 2.0, 0.4, 7.0][:b], np.float32)
    cfg = SamplerConfig(**SAMPLER)
    jcfg = JaxSamplerConfig(**SAMPLER)
    want = np.asarray(jax_assemble_drift(jax_out, jnp.asarray(pos),
                                         jnp.asarray(sigma), jcfg))
    got = assemble_drift(port_out, torch.from_numpy(pos),
                         torch.from_numpy(sigma), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # graph by graph: the drift of a scalar sigma
    for g in range(b):
        one = assemble_drift(port_out, torch.from_numpy(pos),
                             torch.tensor(float(sigma[g])), cfg).numpy()
        np.testing.assert_array_equal(got[g], one[g])


def test_assemble_drift_scalar_sigma_unchanged():
    """A 0-d sigma and the sampler's (1,) sigma give the same bits, and
    JAX's value, on both sides of global_start_sigma."""
    rng = np.random.default_rng(7)
    jax_out, port_out, pos = _outputs(3, 6, rng)
    cfg, jcfg = SamplerConfig(**SAMPLER), JaxSamplerConfig(**SAMPLER)
    for s in (0.2, 3.0):
        zero_d = assemble_drift(port_out, torch.from_numpy(pos),
                                torch.tensor(s), cfg)
        one_d = assemble_drift(port_out, torch.from_numpy(pos),
                               torch.tensor([s]), cfg)
        assert torch.equal(zero_d, one_d)
        want = np.asarray(jax_assemble_drift(jax_out, jnp.asarray(pos),
                                             jnp.float32(s), jcfg))
        np.testing.assert_allclose(zero_d.numpy(), want, rtol=1e-6,
                                   atol=1e-5)


# ---- the loss and the step -------------------------------------------------


def _jax_config(jcfg):
    return JaxConfig(model=jcfg, train=JaxTrainConfig(
        optimizer=JaxOptimizerConfig(**OPT), max_grad_norm=10000.0))


def _port_config(cfg):
    return Config(model=cfg, train=TrainConfig(
        optimizer=OptimizerConfig(**OPT), max_grad_norm=10000.0))


def _draws(key, batch):
    """k and the noise as JAX's loss draws them from `key`."""
    kkey, nkey = jax.random.split(key)
    k = jax.random.randint(kkey, (batch.num_graphs,), 0, N_STUDENT)
    noise = jax.random.normal(nkey, batch.pos.shape, batch.pos.dtype)
    return (torch.from_numpy(np.asarray(k)).long(),
            torch.from_numpy(np.asarray(noise)))


def _student_variables(variables, seed=31):
    """A student a little off its teacher (as after a few steps), so that
    the loss does not start at the teacher's own drift."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v + 0.01 * rng.normal(size=v.shape) *
                             np.abs(v).max(), np.float32),
        variables["params"])


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = configs()
    jb, tb = batches(molecules(3, seed=5), N, batch_size=B)
    model, teacher_vars = jax_variables(jcfg, jb)
    student = {"params": _student_variables(teacher_vars),
               "batch_stats": teacher_vars["batch_stats"]}
    key = jax.random.PRNGKey(5)
    jconf = _jax_config(jcfg)
    sampler = JaxSamplerConfig(**SAMPLER)
    losses = {w: jax_distill.make_distill_loss(model, jconf, sampler,
                                               N_STUDENT, weighting=w)
              for w in distill.WEIGHTINGS}

    def all_weightings(params, stats, teacher, batch, key):
        return {w: jax.value_and_grad(fn)(params, stats, teacher, batch,
                                          key)
                for w, fn in losses.items()}

    want = jax_run(all_weightings, student["params"],
                   student["batch_stats"], teacher_vars, jb, key)
    return dict(jcfg=jcfg, cfg=cfg, jb=jb, tb=tb, model=model,
                teacher=teacher_vars, student=student, key=key, want=want)


def _port_modules(setup):
    teacher = port_model(setup["cfg"], setup["teacher"])
    student = port_model(setup["cfg"], setup["student"])
    return teacher, student


@pytest.mark.parametrize("weighting", distill.WEIGHTINGS)
def test_loss_and_every_gradient_leaf_match_jax(setup, weighting):
    want_loss, grads = setup["want"][weighting]
    teacher, student = _port_modules(setup)
    loss_fn = distill.DistillLoss(_port_config(setup["cfg"]),
                                  SamplerConfig(**SAMPLER), N_STUDENT, "cpu",
                                  weighting)
    k, noise = _draws(setup["key"], setup["jb"])
    loss = loss_fn(student, teacher, setup["tb"], k, noise)
    loss.backward()
    want = float(want_loss)
    assert want > 0.0
    assert abs(float(loss) - want) <= LOSS_RTOL * want
    top = max(float(np.abs(g).max())
              for g in jax.tree_util.tree_leaves(grads))
    seen = 0
    for name, p in student.named_parameters():
        _, path = flax_leaf(student, name)
        g = grads
        for key in path:
            g = g[key]
        g = np.asarray(g)
        got = p.grad.numpy()
        if path[-1] == "kernel":
            got = got.T
        tol = GRAD_RTOL * float(np.abs(g).max()) + GRAD_FLOOR * top
        err = float(np.abs(got - g).max())
        assert err <= tol, f"{weighting} {name}: {err:.3e} > {tol:.3e}"
        seen += 1
    assert seen == len(jax.tree_util.tree_leaves(grads))
    assert all(p.grad is None for p in teacher.parameters())


def test_unknown_weighting_raises(setup):
    with pytest.raises(ValueError, match="unknown weighting"):
        distill.DistillLoss(_port_config(setup["cfg"]),
                            SamplerConfig(**SAMPLER), N_STUDENT, "cpu",
                            "snr")


def _jax_steps(setup, keys):
    """Three of JAX's distill steps: the student's params after each."""
    jconf = _jax_config(setup["jcfg"])
    step = jax_distill.make_distill_step(
        setup["model"], jconf, JaxSamplerConfig(**SAMPLER), N_STUDENT,
        jit=False)
    tx = jax_make_optimizer(jconf.train)
    params = setup["student"]["params"]
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=setup["student"]["batch_stats"],
                          opt_state=tx.init(params))

    compiled = jax.jit(step).lower(
        state, setup["teacher"], setup["jb"], keys[0]).compile(
        compiler_options=FAST_XLA)
    out = []
    for key in keys:
        state, metrics = compiled(state, setup["teacher"], setup["jb"], key)
        out.append((state.params, metrics))
    return out


@pytest.fixture(scope="module")
def three_steps(setup):
    keys = jax.random.split(jax.random.PRNGKey(8), STEPS)
    return keys, _jax_steps(setup, keys)


def test_three_distill_steps_match_jax(setup, three_steps):
    keys, want = three_steps
    teacher, student = _port_modules(setup)
    config = _port_config(setup["cfg"])
    state = distill.create_distill_state(config, teacher, "cpu", 0)
    state.module.load_state_dict(student.state_dict())
    step = distill.make_distill_step(config, SamplerConfig(**SAMPLER),
                                     N_STUDENT, "cpu")
    for s, key in enumerate(keys):
        k, noise = _draws(key, setup["jb"])
        metrics = step(state, teacher, setup["tb"], k, noise)
        params, jm = want[s]
        assert abs(float(metrics.loss) - float(jm.loss)) <= \
            LOSS_RTOL * float(jm.loss)
        assert abs(float(metrics.grad_norm) - float(jm.grad_norm)) <= \
            1e-4 * float(jm.grad_norm)
        got = export_jax_variables(state.module)["params"]
        off = []
        for path, w in jax.tree_util.tree_leaves_with_path(params):
            leaf = got
            for p in path:
                leaf = leaf[p.key]
            off.append(np.abs(leaf - np.asarray(w)).ravel())
        off = np.concatenate(off)
        assert float((off > 0.5 * OPT["lr"]).mean()) <= OFF_SHARE, s
        assert float(np.median(off)) <= OFF_MEDIAN, s
    assert state.step == STEPS


def test_chunked_step_equals_single_steps(setup):
    """K steps through the chunked form equal K single steps, bit for bit
    (a chunk is K steps in a row)."""
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    draws = [_draws(k, setup["jb"]) for k in keys]
    config = _port_config(setup["cfg"])
    teacher, student = _port_modules(setup)
    states = []
    for _ in range(2):
        st = distill.create_distill_state(config, teacher, "cpu", 0)
        st.module.load_state_dict(student.state_dict())
        states.append(st)
    single = distill.make_distill_step(config, SamplerConfig(**SAMPLER),
                                       N_STUDENT, "cpu")
    for k, noise in draws:
        last = single(states[0], teacher, setup["tb"], k, noise)
    chunked = distill.make_chunked_distill_step(
        config, SamplerConfig(**SAMPLER), N_STUDENT, "cpu")
    got = chunked(states[1], teacher, [setup["tb"]] * 2,
                  [d[0] for d in draws], [d[1] for d in draws])
    assert torch.equal(got.loss, last.loss)
    for (name, a), (_, b) in zip(states[0].module.named_parameters(),
                                 states[1].module.named_parameters()):
        assert torch.equal(a, b), name
    assert states[1].step == 2


def test_teacher_unchanged_and_student_statistics_frozen(setup):
    """The student is a copy (no tensor shared with the teacher); a step
    moves its parameters but neither the teacher nor the running
    statistics of either; the draws come from the state's generator."""
    teacher, _ = _port_modules(setup)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    config = _port_config(setup["cfg"])
    state = distill.create_distill_state(config, teacher, "cpu", 3)
    shared = {v.data_ptr() for v in teacher.state_dict().values()}
    assert not shared & {v.data_ptr() for v in
                         state.module.state_dict().values()}
    stats = {k: v.clone() for k, v in state.module.named_buffers()}
    step = distill.make_distill_step(config, SamplerConfig(**SAMPLER),
                                     N_STUDENT, "cpu")
    metrics = step(state, teacher, setup["tb"])
    assert np.isfinite(float(metrics.loss))
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in state.module.named_buffers():
        assert torch.equal(v, stats[k]), k
    moved = [not torch.equal(p, before[n])
             for n, p in state.module.named_parameters()]
    assert sum(moved) > len(moved) // 2


def test_finite_gradients_on_padded_rows(setup):
    """Padded nodes and a padding graph (the fourth) give zero drift rows;
    the clips' norms are differentiable at zero, so every gradient is
    finite."""
    teacher, student = _port_modules(setup)
    tb = setup["tb"]
    assert not bool(tb.graph_mask.all()) and not bool(tb.node_mask.all())
    for weighting in distill.WEIGHTINGS:
        student.zero_grad()
        loss_fn = distill.DistillLoss(_port_config(setup["cfg"]),
                                      SamplerConfig(**SAMPLER), N_STUDENT,
                                      "cpu", weighting)
        k, noise = _draws(jax.random.PRNGKey(11), setup["jb"])
        loss_fn(student, teacher, tb, k, noise).backward()
        for name, p in student.named_parameters():
            assert torch.isfinite(p.grad).all(), (weighting, name)


def test_eval_step_sums(setup):
    """sum_loss is the loss times the real-node count, and count that
    count (agdiff_tpu/train/distill.py:236-252); its draws come from the
    generator passed in, so a reseeded one repeats them."""
    teacher, student = _port_modules(setup)
    config = _port_config(setup["cfg"])
    state = distill.create_distill_state(config, teacher, "cpu", 0)
    state.module.load_state_dict(student.state_dict())
    ev = distill.make_distill_eval_step(config, SamplerConfig(**SAMPLER),
                                        N_STUDENT, "cpu")
    k, noise = _draws(setup["key"], setup["jb"])
    out = ev(state, teacher, setup["tb"], k=k, noise=noise)
    count = float((setup["tb"].node_mask
                   & setup["tb"].graph_mask[:, None]).sum())
    assert float(out["count"]) == count
    want = float(setup["want"]["trunc-snr"][0])
    assert abs(float(out["sum_loss"]) / count - want) <= LOSS_RTOL * want
    a = ev(state, teacher, setup["tb"], torch.Generator().manual_seed(4))
    b = ev(state, teacher, setup["tb"], torch.Generator().manual_seed(4))
    assert torch.equal(a["sum_loss"], b["sum_loss"])


# ---- the CLI ---------------------------------------------------------------


def _teacher_run(root):
    cfg = root / "small.yml"
    with open(cfg, "w") as f:
        yaml.safe_dump({"model": dict(SMALL),
                        "train": {"seed": 3, "batch_size": 4, "val_freq": 3,
                                  "max_iters": 3, "ema_decay": 0.9},
                        "buckets": {"max_nodes": [16]}}, f)
    return train_cli.main([str(cfg), "--logdir", str(root / "logs"),
                           *SYNTH]).log_dir


def test_cli_stages_skip_resume_generate_and_serve(tmp_path):
    teacher = _teacher_run(tmp_path)
    logdir = str(tmp_path / "distill")
    args = [teacher, "--ema_teacher", "--stages", "4,2", "--iters", "4",
            "--val_freq", "2", "--batch_size", "4", "--logdir", logdir,
            *SYNTH]
    summary = distill_cli.main(args)
    assert [s["stage"] for s in summary] == [4, 2]
    for n in (4, 2):
        stage = os.path.join(logdir, f"stage{n}")
        with open(os.path.join(stage, "DONE.json")) as f:
            done = json.load(f)
        assert done["stage"] == n and done["iters"] == 4
        assert np.isfinite(done["best_val"])
        assert sorted(os.listdir(os.path.join(stage, "checkpoints"))) == \
            ["2", "4"]
    with open(os.path.join(logdir, "STAGES.json")) as f:
        stages = json.load(f)
    assert set(stages) == {"stages", "weighting", "sampler"}
    assert stages["weighting"] == "trunc-snr"
    assert stages["sampler"]["ladder"] == "strided"
    assert stages["sampler"]["clip_local"] == 20.0

    # a rerun skips both stages
    again = distill_cli.main(args)
    assert all(s.get("resumed") for s in again)
    assert [s["best_val"] for s in again] == [s["best_val"] for s in summary]

    # stage 2 cut after its first checkpoint: DONE.json and the later
    # checkpoint gone, the best pointer at the first; the rerun resumes
    # from iteration 2 and finishes the stage
    stage2 = os.path.join(logdir, "stage2")
    os.remove(os.path.join(stage2, "DONE.json"))
    shutil.rmtree(os.path.join(stage2, "checkpoints", "4"))
    first = os.path.join(os.path.abspath(stage2), "checkpoints", "2")
    with open(os.path.join(stage2, "best_model", "POINTER"), "w") as f:
        f.write(first)
    distill_cli.main(args)
    with open(os.path.join(logdir, "log.txt")) as f:
        log = f.read()
    assert "[stage 2] resuming from iter 2" in log
    assert os.path.exists(os.path.join(stage2, "DONE.json"))
    assert os.path.isdir(os.path.join(stage2, "checkpoints", "4"))

    # the stage's student through the generation CLI, on its grid
    out = str(tmp_path / "samples")
    gen_cli.main([stage2, "--synthetic", "1", "--synthetic_heavy", "4",
                  "--fast", "--ladder", "strided", "--sampling_type",
                  "generalized", "--eta", "0", "--n_steps", "2",
                  "--w_global", "0.3", "--clip_local", "20",
                  "--num_confs", "2", "--out_dir", out, "--device", "cpu"])
    (mol,) = load_samples(os.path.join(out, "samples_all.npz"))
    assert mol.meta["pos_gen"].shape == (2, mol.num_nodes, 3)
    assert np.isfinite(mol.meta["pos_gen"]).all()

    # and through the server CLI
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    server = threading.Thread(target=serve_cli.main, daemon=True, args=([
        stage2, "--fast", "--packed", "--batch_window", "0.1", "--ladder",
        "strided", "--sampling_type", "generalized", "--eta", "0",
        "--n_steps", "2", "--w_global", "0.3", "--clip_local", "20",
        "--port", str(port), "--device", "cpu"],))
    server.start()
    deadline = time.time() + 60
    while True:
        try:
            ping = submit({"cmd": "ping"}, port=port, timeout=10)
            break
        except OSError:
            assert time.time() < deadline, "the server did not start"
            time.sleep(0.2)
    reply = submit({"cmd": "generate", "synthetic": 1, "synthetic_heavy": 4,
                    "num_confs": 2, "save": False, "return_pos": True},
                   port=port, timeout=120)
    assert ping["ok"] and reply["ok"] and reply["samples"] == 2
    assert np.isfinite(np.asarray(reply["pos"][0])).all()
    assert submit({"cmd": "shutdown"}, port=port, timeout=60)["shutdown"]
    server.join(timeout=60)
    assert not server.is_alive()
