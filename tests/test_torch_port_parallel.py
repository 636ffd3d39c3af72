"""Data parallelism (agdiff_torch/parallel/) against the JAX package's on
the CPU: two gloo ranks spawned once for the module (`agdiff_torch.
parallel.launch`, tests/torch_port_dp_ranks.py) run every case, and the
JAX references run on the conftest's virtual CPU devices, `make_mesh(2)`
with the batch's graph axis sharded.

  (a) the DP train step against JAX's DP step (`make_parallel_train_step`
      over the mesh; its gradient leaves from JAX's loss jitted with the
      same shardings), dense and packed_pairs, on a batch whose ranks hold
      uneven real-node counts (15 + 12 nodes against 12 and a padding
      graph), t and the noise drawn as JAX's step draws them from its key
      and injected; also against the port's single-process step;
  (b) world size 1 against no group, bit for bit (in this process);
  (c) planted faults (per-rank BatchNorm statistics, statistics through
      an all-reduce without gradient, DDP's mean of per-rank means, each
      rank drawing only its own share of the noise) break (a)'s limits;
  (d) one bf16 DP step against JAX's bf16 DP step;
  (e) the DP distill step against JAX's `make_parallel_distill_step`;
      the chunked DP step against its steps one by one;
  (f) the DP sampler against JAX's sharded samplers (`build_fast_sampler(
      mesh=...)`, `make_parallel_sampler`): 'pksf' and 'tight-pksf' (K1's
      plain twin here, JAX's kernel in interpret mode) on strided DDIM at
      eta 0, and the module path at eta 1 with JAX's noise replayed (the
      global draw, sliced); each rank's forwards; also against the port's
      single-process sampler, and the DP runner against the single one at
      the same seed;
  (h) refusals: a batch that does not split, a mesh outside a world;
  a data-parallel server's runner call that fails on every rank raises
  its error on each, one that fails on one rank only raises RanksDisagree
  on both.

Tolerances (small model: hidden 32, 2 + 2 convs, T = 100, bucket 16):
  * f32 steps, as tests/test_torch_port_train.py: losses LOSS_RTOL
    relative, running statistics STATS_ATOL, each gradient leaf max |diff|
    <= GRAD_RTOL x its largest |g| + GRAD_FLOOR x the model's largest;
    parameters after the step, as tests/test_torch_port_distill.py (an
    Adam step moves an element by about lr x the sign of its gradient,
    which rounding noise can flip): at most OFF_SHARE of the elements
    off by more than lr / 2 and a median |diff| <= OFF_MEDIAN;
  * against the port's single-process step: loss SINGLE_RTOL relative,
    the gradients at the limits above;
  * bf16, as tests/test_torch_port_bf16.py: loss BF16_LOSS_RTOL, statistics
    BF16_STATS_RTOL of max(|stat|, 1), each leaf max |diff| <=
    BF16_GRAD_TOP_REL x the model's largest |g|, median over leaves of
    |diff| / |g| <= BF16_GRAD_MEDIAN;
  * samplers: f32 positions atol POS_ATOL (tests/test_torch_port_ladder.
    py), bf16 engines POS_REL x the largest |pos|; DP against the port's
    single process: DP_POS_ATOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from agdiff_tpu.config import (
    Config as JaxConfig,
    OptimizerConfig as JaxOptimizerConfig,
    TrainConfig as JaxTrainConfig,
)
from agdiff_tpu.models.loss import (
    diffusion_loss as jax_diffusion_loss,
    perturb_positions as jax_perturb,
    sample_timesteps as jax_sample_timesteps,
)
from agdiff_tpu.models.schedules import make_diffusion as jax_diffusion
from agdiff_tpu.ops.pallas import stack_packed as jax_stack
from agdiff_tpu.parallel import make_mesh as jax_make_mesh
from agdiff_tpu.parallel.data_parallel import (
    _batch_spec,
    make_parallel_sampler as jax_dp_sampler,
    shard_graph_batch as jax_shard,
)
from agdiff_tpu.sampling.langevin import (
    SamplerConfig as JaxSamplerConfig,
    build_fast_sampler as jax_fast_sampler,
)
from agdiff_tpu.train import distill as jax_distill
from agdiff_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from agdiff_tpu.train.train_step import (
    TrainState as JaxTrainState,
    make_train_step as jax_train_step,
)

from agdiff_torch.config import Config, OptimizerConfig, TrainConfig
from agdiff_torch.eval.generate import MODULE
from agdiff_torch.models.weights import flax_leaf
from agdiff_torch.ops.pairs import pair_capacity_for
from agdiff_torch.parallel import (
    batch_sharding,
    launch,
    make_mesh,
    replicated,
)
from agdiff_torch.parallel.mesh import Mesh, free_port, join
from agdiff_torch.sampling.langevin import SamplerConfig

import torch_port_dp_ranks as ranks
from test_torch_port_common import (
    FAST_XLA,
    batches,
    configs,
    jax_variables,
    molecules,
    port_model,
    port_molecule,
)

LOSS_RTOL = 1e-5
STATS_ATOL = 1e-5
GRAD_RTOL = 2e-4
GRAD_FLOOR = 2e-7
OFF_SHARE = 0.02
OFF_MEDIAN = 1e-7
SINGLE_RTOL = 1e-6
BF16_LOSS_RTOL = 1e-3
BF16_STATS_RTOL = 1e-3
BF16_GRAD_TOP_REL = 6e-2
BF16_GRAD_MEDIAN = 7e-2
POS_ATOL = 1e-4
POS_REL = 1e-2
DP_POS_ATOL = 1e-5
NARROW_XLA = {**FAST_XLA, "xla_allow_excess_precision": False}
B, N, N_STUDENT, STEPS = 4, 16, 4, 3
OPT = dict(lr=1e-3, beta1=0.95, beta2=0.999)
DDIM0 = dict(n_steps=STEPS, ladder="strided", sampling_type="generalized",
             eta=0.0, w_global=0.3, clip_local=20.0)
DDIM1 = dict(DDIM0, eta=1.0)
DISTILL = dict(sampling_type="generalized", eta=0.0, ladder="strided",
               w_global=0.3, global_start_sigma=0.5, clip=1000.0,
               clip_local=20.0)


def _configs(jcfg, cfg):
    return (JaxConfig(model=jcfg, train=JaxTrainConfig(
                optimizer=JaxOptimizerConfig(**OPT))),
            Config(model=cfg, train=TrainConfig(
                optimizer=OptimizerConfig(**OPT))))


def _torch(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _sharded_jit(fn, mesh, *args, batch_arg=1, options=FAST_XLA):
    """fn(*args) jitted as JAX's DP steps are (agdiff_tpu/parallel/
    data_parallel.py make_parallel_train_step, make_parallel_distill_step:
    the single-device step's function under these shardings): argument
    `batch_arg` (a GraphBatch) sharded on its graph axis over the mesh,
    the rest replicated."""
    repl = NamedSharding(mesh, P())
    batch_sh = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s),
                                      _batch_spec(mesh))
    shardings = tuple(batch_sh if i == batch_arg else repl
                      for i in range(len(args)))
    return jax.jit(fn, in_shardings=shardings).lower(*args).compile(
        compiler_options=options)(*args)


# ---- the train and distill steps --------------------------------------------


def _train_reference(mesh, options, **model):
    """The inputs of a train case and JAX's DP step on them: (case,
    (new state, metrics, gradients))."""
    jcfg, cfg = configs(**model)
    jconf, conf = _configs(jcfg, cfg)
    jb, tb = batches(molecules(3, seed=5), N, batch_size=B)
    model, variables = jax_variables(jcfg, jb)
    key = jax.random.PRNGKey(11)
    alphas = jnp.asarray(jax_diffusion(jcfg).alphas)
    tkey, nkey = jax.random.split(key)
    t = jax_sample_timesteps(tkey, B, jcfg.num_diffusion_timesteps)
    noise = jax.random.normal(nkey, jb.pos.shape, jb.pos.dtype)

    def loss_fn(params, stats, batch, key):
        # agdiff_tpu/train/train_step.py:73-86, the step's own draws
        tkey, nkey = jax.random.split(key)
        t = jax_sample_timesteps(tkey, batch.num_graphs,
                                 jcfg.num_diffusion_timesteps)
        pos_p, a = jax_perturb(nkey, batch, alphas, t)
        out = model.apply({"params": params, "batch_stats": stats},
                          batch.replace(pos=pos_p), train=True,
                          mutable=["batch_stats"])[0]
        return jax_diffusion_loss(out, batch, pos_p, a, jcfg.cutoff).loss

    tx = jax_make_optimizer(jconf.train)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    inner = jax_train_step(model, jconf, jit=False)

    def step(state, batch, key):
        return (*inner(state, batch, key),
                jax.grad(loss_fn)(state.params, state.batch_stats, batch,
                                  key))

    new_state, metrics, grads = _sharded_jit(step, mesh, state, jb, key,
                                             options=options)
    case = dict(kind="train", config=conf, variables=variables, batch=tb,
                t=_torch(t).long(), noise=_torch(noise))
    return case, (new_state, metrics, grads)


def _distill_reference(mesh):
    jcfg, cfg = configs()
    jconf, conf = _configs(jcfg, cfg)
    jb, tb = batches(molecules(3, seed=5), N, batch_size=B)
    model, teacher = jax_variables(jcfg, jb)
    rng = np.random.default_rng(31)
    student = {"params": jax.tree_util.tree_map(
        lambda v: np.asarray(v + 0.01 * rng.normal(size=v.shape)
                             * np.abs(v).max(), np.float32),
        teacher["params"]), "batch_stats": teacher["batch_stats"]}
    key = jax.random.PRNGKey(5)
    kkey, nkey = jax.random.split(key)
    k = jax.random.randint(kkey, (B,), 0, N_STUDENT)
    noise = jax.random.normal(nkey, jb.pos.shape, jb.pos.dtype)
    jsampler = JaxSamplerConfig(**DISTILL)
    tx = jax_make_optimizer(jconf.train)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=student["params"],
                          batch_stats=student["batch_stats"],
                          opt_state=tx.init(student["params"]))
    inner = jax_distill.make_distill_step(model, jconf, jsampler, N_STUDENT,
                                          jit=False)
    loss = jax_distill.make_distill_loss(model, jconf, jsampler, N_STUDENT)

    def step(state, teacher, batch, key):
        return (*inner(state, teacher, batch, key),
                jax.grad(loss)(state.params, state.batch_stats, teacher,
                               batch, key))

    new_state, metrics, grads = _sharded_jit(step, mesh, state, teacher, jb,
                                             key, batch_arg=2)
    case = dict(kind="distill", config=conf, variables=teacher,
                student=student, batch=tb, k=_torch(k).long(),
                noise=_torch(noise), sampler=SamplerConfig(**DISTILL),
                n_student=N_STUDENT)
    return case, (new_state, metrics, grads)


# ---- the samplers -----------------------------------------------------------


def _replayed_noise(key, steps, shape):
    """The noise JAX's ladder draws (key, noise_key = split(key) a step),
    at the global batch's shape."""
    out = []
    for _ in range(steps):
        key, noise_key = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(noise_key, shape,
                                                jnp.float32)))
    return torch.from_numpy(np.stack(out))


def _sample_reference(engine, mesh):
    """(case, JAX's sharded sampler's positions): one molecule repeated
    B times (the runner's chunk), pos_init and JAX's noise injected."""
    dtype = "float32" if engine == MODULE else "bfloat16"
    jcfg, cfg = configs(dtype=dtype)
    mol = molecules(1, seed=11)[0]
    jb, tb = batches([mol] * B, N)
    _, variables = jax_variables(jcfg, jb)
    kw = DDIM1 if engine == MODULE else DDIM0
    pos_init = np.random.default_rng(2).normal(
        size=tb.pos.shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    cap = (pair_capacity_for(mol.num_nodes, 16) if engine.startswith(
        "tight") else None)
    diffusion = jax_diffusion(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_stack, "_INTERPRET", True)
        if engine == MODULE:
            from agdiff_tpu.models.dualenc import get_model

            run = jax_dp_sampler(get_model(jcfg), diffusion,
                                 JaxSamplerConfig(**kw), mesh)
            args = (variables, jax_shard(jb, mesh), jnp.asarray(pos_init),
                    key)
        else:
            run = jax_fast_sampler(jcfg, variables, diffusion,
                                   JaxSamplerConfig(**kw), use_pallas=False,
                                   engine=engine, pair_capacity=cap,
                                   shared_pairs=cap is not None, mesh=mesh)
            args = (jax_shard(jb, mesh), jnp.asarray(pos_init), key)
        ref = run.lower(*args).compile(compiler_options=NARROW_XLA)(*args)
    case = dict(kind="sample", model_config=cfg, variables=variables,
                engine=engine, capacity=cap, sampler=SamplerConfig(**kw),
                batch=tb, pos_init=torch.from_numpy(pos_init),
                noise=_replayed_noise(key, STEPS, tb.pos.shape))
    return case, ref


SAMPLE_ENGINES = ("pksf", "tight-pksf", MODULE)


def _runner_case():
    jcfg, cfg = configs()
    mols = [port_molecule(m) for m in molecules(2, seed=3)]
    jb, _ = batches(molecules(2, seed=3), N)
    _, variables = jax_variables(jcfg, jb)
    return dict(kind="runner", model_config=cfg, variables=variables,
                engine=MODULE, sampler=SamplerConfig(**DDIM1),
                buckets=(N,), chunk=8, molecules=mols, seed=4,
                num_confs=12)


@pytest.fixture(scope="module")
def world():
    """JAX's references, then every case run once in a world of two gloo
    ranks: (references, cases, [each rank's results])."""
    mesh = jax_make_mesh(2)
    refs, cases = {}, {}
    for name, options, model in (
            ("dense", FAST_XLA, {}),
            ("packed", FAST_XLA, dict(packed_pairs=True)),
            ("bf16", NARROW_XLA, dict(dtype="bfloat16"))):
        cases[name], refs[name] = _train_reference(mesh, options, **model)
    for fault in ranks.FAULTS:
        cases[f"fault {fault}"] = dict(cases["dense"], fault=fault)
    cases["chunked"] = dict(cases["dense"], kind="chunked")
    cases["distill"], refs["distill"] = _distill_reference(mesh)
    for engine in SAMPLE_ENGINES:
        cases[f"sample {engine}"], refs[f"sample {engine}"] = \
            _sample_reference(engine, mesh)
    cases["runner"] = _runner_case()
    cases["outcomes"] = dict(kind="outcomes")
    return refs, cases, launch(ranks.run_cases, 2, cases, device="cpu")


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _flax(model, name, x):
    """A port tensor as the flax leaf it maps to (kernels transposed)."""
    _, path = flax_leaf(model, name)
    x = x.numpy()
    return path, (x.T if path[-1] == "kernel" else x)


def _grad_errors(model, got, want_tree):
    """[(name, max |diff|, limit)] over every gradient leaf, at the f32
    limits."""
    top = max(float(np.abs(g).max())
              for g in jax.tree_util.tree_leaves(want_tree))
    assert top > 0.0
    rows = []
    for name, g in got.items():
        path, g = _flax(model, name, g)
        want = _leaf(want_tree, path)
        rows.append((name, float(np.abs(g - want).max()),
                     GRAD_RTOL * float(np.abs(want).max())
                     + GRAD_FLOOR * top))
    assert len(rows) == len(jax.tree_util.tree_leaves(want_tree))
    return rows


def _broken(case, got, ref, model):
    """The f32 limits of (a) that `got` (one rank's result) breaks."""
    new_state, metrics, grads = ref
    broken = []
    want = float(metrics.loss)
    if not abs(got["metrics"][0] - want) <= LOSS_RTOL * want:
        broken.append("loss")
    for name, buf in got["buffers"].items():
        path, b = _flax(model, name, buf)
        if not np.abs(b - _leaf(new_state.batch_stats, path)).max() \
                <= STATS_ATOL:
            broken.append(f"stats {name}")
    broken += [f"grad {n}" for n, err, tol in
               _grad_errors(model, got["grads"], grads) if not err <= tol]
    off = []
    for name, p in got["params"].items():
        path, p = _flax(model, name, p)
        off.append(np.abs(p - _leaf(new_state.params, path)).ravel())
    off = np.concatenate(off)
    if not (float((off > 0.5 * OPT["lr"]).mean()) <= OFF_SHARE
            and float(np.median(off)) <= OFF_MEDIAN):
        broken.append("params")
    return broken


def _model(case):
    return port_model(case["config"].model, case["variables"])


@pytest.mark.parametrize("name", ["dense", "packed"])
def test_dp_train_step_matches_jax_dp_step(world, name):
    refs, cases, out = world
    case = cases[name]
    nodes = case["batch"].node_mask.sum(1).tolist()
    assert nodes[0] + nodes[1] != nodes[2] + nodes[3] and nodes[3] == 0
    model = _model(case)
    for r, got in enumerate(out):
        assert _broken(case, got[name], refs[name], model) == [], r
    # every rank holds the same parameters, statistics and gradients
    for part in ("params", "buffers", "grads"):
        for n, x in out[0][name][part].items():
            assert torch.equal(x, out[1][name][part][n]), (part, n)
    want = refs[name][1]
    for got, w in zip(out[0][name]["metrics"],
                      (want.loss, want.loss_global, want.loss_local,
                       want.grad_norm)):
        assert abs(got - float(w)) <= 1e-4 * float(w)


@pytest.mark.parametrize("name", ["dense", "packed"])
def test_dp_train_step_matches_the_single_process_step(world, name):
    _, cases, out = world
    single = ranks.train_case(None, cases[name])
    got = out[0][name]
    assert abs(got["metrics"][0] - single["metrics"][0]) <= \
        SINGLE_RTOL * single["metrics"][0]
    top = max(float(g.abs().max()) for g in single["grads"].values())
    for n, g in single["grads"].items():
        err = float((got["grads"][n] - g).abs().max())
        assert err <= GRAD_RTOL * float(g.abs().max()) + GRAD_FLOOR * top, n
    for n, b in single["buffers"].items():
        assert float((got["buffers"][n] - b).abs().max()) <= STATS_ATOL, n


@pytest.mark.parametrize("fault", ranks.FAULTS)
def test_planted_faults_break_the_limits(world, fault):
    refs, cases, out = world
    name = f"fault {fault}"
    broken = _broken(cases[name], out[0][name], refs["dense"],
                     _model(cases[name]))
    assert broken, f"{fault} breaks no limit"


def test_chunked_step_equals_single_steps(world):
    """make_parallel_chunked_train_step over two shards: the parameters of
    two data-parallel steps, bit for bit."""
    _, _, out = world
    for chunked, steps in (r["chunked"] for r in out):
        assert chunked.keys() == steps.keys()
        for n, p in chunked.items():
            assert torch.equal(p, steps[n]), n


def test_world_of_one_equals_no_group():
    """A group of one rank (gloo, in this process) gives the bits of the
    step without a group: loss, gradients, parameters, statistics."""
    jcfg, cfg = configs()
    jb, tb = batches(molecules(3, seed=5), N, batch_size=B)
    _, variables = jax_variables(jcfg, jb)
    rng = np.random.default_rng(3)
    case = dict(kind="train", config=_configs(jcfg, cfg)[1],
                variables=variables, batch=tb,
                t=torch.as_tensor(rng.integers(0, 100, B)),
                noise=torch.as_tensor(rng.normal(size=(B, N, 3)),
                                      dtype=torch.float32))
    alone = ranks.train_case(None, case)
    with join(0, 1, free_port(), "gloo", "cpu") as group:
        assert make_mesh(1) == group
        one = ranks.train_case(group, case)
    assert one["metrics"] == alone["metrics"]
    for part in ("grads", "params", "buffers"):
        for n, x in alone[part].items():
            assert torch.equal(one[part][n], x), (part, n)


def test_bf16_dp_train_step_matches_jax(world):
    refs, cases, out = world
    new_state, metrics, grads = refs["bf16"]
    got = out[0]["bf16"]
    model = _model(cases["bf16"])
    for g, w in zip(got["metrics"][:3], (metrics.loss, metrics.loss_global,
                                         metrics.loss_local)):
        assert abs(g - float(w)) <= BF16_LOSS_RTOL * float(w)
    for name, buf in got["buffers"].items():
        path, b = _flax(model, name, buf)
        want = _leaf(new_state.batch_stats, path)
        assert np.abs(b - want).max() <= BF16_STATS_RTOL * max(
            float(np.abs(want).max()), 1.0), name
    top = max(float(np.abs(g).max())
              for g in jax.tree_util.tree_leaves(grads))
    norm_rel = []
    for name, g in got["grads"].items():
        path, g = _flax(model, name, g)
        want = _leaf(grads, path)
        assert np.abs(g - want).max() <= BF16_GRAD_TOP_REL * top, name
        norm_rel.append(np.linalg.norm(g - want)
                        / max(np.linalg.norm(want), 1e-30))
    assert float(np.median(norm_rel)) <= BF16_GRAD_MEDIAN


def test_dp_distill_step_matches_jax(world):
    refs, cases, out = world
    new_state, metrics, grads = refs["distill"]
    case = cases["distill"]
    model = port_model(case["config"].model, case["student"])
    for got in (out[0]["distill"], out[1]["distill"]):
        assert abs(got["metrics"][0] - float(metrics.loss)) <= \
            LOSS_RTOL * float(metrics.loss)
        assert all(err <= tol for _, err, tol in
                   _grad_errors(model, got["grads"], grads))
        off = np.concatenate([
            np.abs(_flax(model, n, p)[1] - _leaf(
                new_state.params, _flax(model, n, p)[0])).ravel()
            for n, p in got["params"].items()])
        assert float((off > 0.5 * OPT["lr"]).mean()) <= OFF_SHARE
        assert float(np.median(off)) <= OFF_MEDIAN
    single = ranks.distill_case(None, case)
    assert abs(out[0]["distill"]["metrics"][0] - single["metrics"][0]) <= \
        SINGLE_RTOL * single["metrics"][0]


@pytest.mark.parametrize("engine", SAMPLE_ENGINES)
def test_dp_sampler_matches_jax_sharded_sampler(world, engine):
    refs, cases, out = world
    name = f"sample {engine}"
    ref = np.asarray(refs[name].pos)
    got = out[0][name]
    assert torch.equal(got["pos"], out[1][name]["pos"])
    assert not got["flags"].any()
    assert np.isfinite(ref).all()
    limit = POS_ATOL if engine == MODULE else POS_REL * np.abs(ref).max()
    np.testing.assert_allclose(got["pos"].numpy(), ref, atol=limit)
    if engine != MODULE:
        # each rank ran its forward once a step, on its two graphs
        assert [r[name]["calls"] for r in out] == [STEPS, STEPS]
    single = ranks.sample_case(None, cases[name])
    np.testing.assert_allclose(got["pos"].numpy(), single["pos"].numpy(),
                               atol=DP_POS_ATOL)


def test_dp_runner_matches_the_single_runner(world):
    _, cases, out = world
    single = ranks.runner_case(None, cases["runner"])
    assert [p.shape[0] for p in single] == [12, 12]
    for got, want in zip(out[0]["runner"], single):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=DP_POS_ATOL)


def test_server_calls_compare_the_ranks_outcomes(world):
    _, _, out = world
    for rank, got in enumerate(out):
        assert got["outcomes"] == {"ok": rank,
                                   "fails_everywhere": "ValueError",
                                   "fails_on_rank_1": "RanksDisagree"}


def test_shards_and_refusals():
    """A rank's rows of the graph axis, and the refusals: a batch that
    does not split, a mesh outside a world, 1-D or multi-slice (the
    ('dcn', 'dp') mesh itself: tests/test_torch_port_sharded.py)."""
    group = Mesh(2, 1, torch.device("cpu"), "gloo")
    assert batch_sharding(group, 8) == slice(4, 8)
    assert replicated(group) == slice(None)
    with pytest.raises(ValueError, match="does not split"):
        group.rows(3)
    with pytest.raises(RuntimeError, match="no world"):
        make_mesh(2, dcn_slices=2)
    with pytest.raises(RuntimeError, match="no world"):
        make_mesh(2)
