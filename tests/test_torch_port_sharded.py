"""Sharded training layouts (agdiff_torch/parallel/sharded.py: FSDP,
tensor parallelism and spatial (node-axis) sharding), the multi-slice
('dcn', 'dp') mesh and the mesh's collectives
(agdiff_torch/parallel/mesh.py) against the JAX package's on the CPU.
One world of four gloo ranks, spawned once for the module
(`agdiff_torch.parallel.launch`, tests/torch_port_shard_ranks.py), runs
every case; the JAX references run on the conftest's eight virtual CPU
devices.

The port's meshes are (2, 2) over its four ranks: ('dp', 'fsdp') and
('dp', 'tp'). JAX's tests (tests/test_sharded_parallel.py) run on a (2, 4)
mesh of eight devices, so the port's steps are held against JAX's single
step and against JAX's sharded step on that (2, 4) mesh, and the specs
against JAX's on a mesh whose model axis has the port's size, 2. The dcn
step runs on a (2, 2) ('dcn', 'dp') mesh where JAX's test
(tests/test_train_eval.py:751-776) takes (2, 4).

Tolerances are JAX's own (tests/test_sharded_parallel.py:60-97): the loss
rtol 1e-5, the gradient norm rtol 1e-4, the Adam moments rtol 2e-3 and
atol 1e-2, the parameters rtol 1e-3 and atol 3e-3; the dcn loss rtol
1e-5. Each gradient leaf is also held as tests/test_torch_port_parallel.py
holds the DP step's: max |diff| <= GRAD_RTOL x its largest |g| +
GRAD_FLOOR x the model's largest.

Mode 'sp' runs on ('dp', 'sp') meshes of (2, 2) and (1, 2) (the first two
ranks of the world, as JAX's make_hybrid_mesh takes the first devices),
f32 and under remat, against JAX's single step and JAX's sp step on its
(4, 2) mesh at the same tolerances; at bf16 against the port's
single-process bf16 step (which tests/test_torch_port_bf16.py holds
against JAX's) at chip_smoke.py phase 11's limits. Its shard shapes are
JAX's shard_shape on the same meshes, and planted faults (the transposed
terms dropped, per-rank statistics, h_j not gathered, a per-rank count)
break the limits. The same with packed_pairs: each rank holds its owned
pairs of the triangle (ops/pairs.py owned_pairs), held against JAX's sp
step on the packed config and its single packed step (f32), or the
port's single packed bf16 step, with three faults of its own (the j-side
messages kept on the owner, the mirror's lower half dropped, a pair
owned twice) and the ownership rule checked directly.
"""

import dataclasses
import json
import os
import sys
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agdiff_tpu.config import (
    Config as JaxConfig,
    OptimizerConfig as JaxOptimizerConfig,
    TrainConfig as JaxTrainConfig,
    load_config as jax_load_config,
)
from agdiff_tpu.models.dualenc import get_model
from agdiff_tpu.models.loss import (
    diffusion_loss as jax_diffusion_loss,
    perturb_positions as jax_perturb,
    sample_timesteps as jax_sample_timesteps,
)
from agdiff_tpu.models.schedules import make_diffusion as jax_diffusion
from agdiff_tpu.parallel import sharded as jax_sharded
from agdiff_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from agdiff_tpu.train.train_step import (
    TrainState as JaxTrainState,
    create_train_state as jax_create_train_state,
    make_train_step as jax_train_step,
)

from agdiff_torch.config import (
    Config,
    OptimizerConfig,
    TrainConfig,
    load_config,
)
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.weights import flax_leaf
from agdiff_torch.ops.pairs import owned_pairs
from agdiff_torch.parallel import launch
from agdiff_torch.parallel import sharded as sh
from agdiff_torch.parallel.mesh import Mesh
from agdiff_torch.train.optimizer import make_optimizer
from agdiff_torch.train.train_step import TrainState, make_train_step

import torch_port_shard_ranks as ranks
from test_torch_port_common import (
    FAST_XLA,
    batches,
    configs,
    jax_variables,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_FIXTURE = os.path.join(ROOT, "tests", "torch_port_jax_specs.json")
#: the configs chip_smoke.py phase 14 shards, at a model axis of 2
SPEC_CONFIGS = ("synthetic_qm9.yml", "qm9_fast.yml")
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
MOMENT_RTOL, MOMENT_ATOL = 2e-3, 1e-2
PARAM_RTOL, PARAM_ATOL = 1e-3, 3e-3
GRAD_RTOL, GRAD_FLOOR = 2e-4, 2e-7
B, N = 8, 16
OPT = dict(lr=1e-3, beta1=0.95, beta2=0.999)
SMALL = dict(hidden_dim=32, num_convs=2, num_convs_local=2,
             num_diffusion_timesteps=50)
EMA = 0.999
#: the port's ('dp', 'sp') meshes of the sp cases, dense and packed_pairs
SP_DIMS = {"sp 2x2": (2, 2), "sp 1x2": (1, 2), "sp remat": (2, 2),
           "sp packed 2x2": (2, 2), "sp packed 1x2": (1, 2),
           "sp packed remat": (2, 2)}
#: chip_smoke.py phase 11's limits of a bf16 step (BF16_STEP_LIMITS)
BF16_LIMITS = dict(loss_rel=1.5e-3, grad_top_rel=0.1, grad_norm_median=7e-2,
                   stats_max_rel=2.5e-3)
SHAPE_FIELDS = ("atom_type", "pos", "node_mask", "bond_adj", "graph_mask")


def _configs():
    jcfg, cfg = configs(**SMALL)
    train = dict(batch_size=B, ema_decay=EMA)
    return (JaxConfig(model=jcfg, train=JaxTrainConfig(
                optimizer=JaxOptimizerConfig(**OPT), **train)),
            Config(model=cfg, train=TrainConfig(
                optimizer=OptimizerConfig(**OPT), **train)))


def _jax_state(jconf, model, variables):
    tx = jax_make_optimizer(jconf.train)
    params = variables["params"]
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=variables["batch_stats"],
                         opt_state=tx.init(params),
                         ema_params=jax.tree_util.tree_map(np.copy, params))


def background(fn, *args, **kwargs):
    """fn(*args, **kwargs) started on a thread (the ranks' world runs while
    JAX compiles its references); returns a function that waits for its
    result, raising its error."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: B902 (re-raised in the caller)
            box["err"] = e
    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "err" in box:
            raise box["err"]
        return box["out"]
    return wait


def _compiled(fn, *args):
    return fn.lower(*args).compile(compiler_options=FAST_XLA)(*args)


@pytest.fixture(scope="module")
def world():
    """Every case run once in a world of four gloo ranks while JAX's
    single step and its (2, 4) fsdp and tp steps compile and run on the
    same batch and key: (references, cases, [each rank's results])."""
    jconf, conf = _configs()
    from agdiff_tpu.data.synthetic import synthetic_dataset

    mols = synthetic_dataset(B, seed=0, min_heavy=3, max_heavy=4)
    jb, tb = batches(mols, N, batch_size=B)
    model, variables = jax_variables(jconf.model, jb)
    jpacked = _packed(jconf)
    models = {"": model, " packed": get_model(jpacked.model)}
    key = jax.random.PRNGKey(5)
    tkey, nkey = jax.random.split(key)
    t = jax_sample_timesteps(tkey, B, jconf.model.num_diffusion_timesteps)
    noise = jax.random.normal(nkey, jb.pos.shape, jb.pos.dtype)
    alphas = jnp.asarray(jax_diffusion(jconf.model).alphas)

    def loss_fn(params, stats, batch, key, model=model):
        tkey, nkey = jax.random.split(key)
        t = jax_sample_timesteps(tkey, batch.num_graphs,
                                 jconf.model.num_diffusion_timesteps)
        pos_p, a = jax_perturb(nkey, batch, alphas, t)
        out = model.apply({"params": params, "batch_stats": stats},
                          batch.replace(pos=pos_p), train=True,
                          mutable=["batch_stats"])[0]
        return jax_diffusion_loss(out, batch, pos_p, a,
                                  jconf.model.cutoff).loss

    base = dict(config=conf, variables=variables, batch=tb,
                t=torch.from_numpy(np.array(t)).long(),
                noise=torch.from_numpy(np.array(noise)))
    cases = {mode: dict(base, kind="sharded", mode=mode)
             for mode in ("fsdp", "tp")}
    for fault, mode in (("shard_unsummed", "fsdp"),
                        ("partial_unreduced", "tp"),
                        ("own_shard_norm", "fsdp")):
        cases[f"fault {fault}"] = dict(cases[mode], fault=fault)
    for name, dims in SP_DIMS.items():
        model_conf = dataclasses.replace(conf.model, remat="remat" in name,
                                         packed_pairs="packed" in name)
        cases[name] = dict(base, kind="sp", dims=dims,
                           config=dataclasses.replace(conf, model=model_conf))
    bf16 = dataclasses.replace(conf, model=dataclasses.replace(
        conf.model, dtype="bfloat16"))
    cases["sp bf16"] = dict(base, kind="sp", dims=(2, 2), config=bf16)
    cases["sp packed bf16"] = dict(base, kind="sp", dims=(2, 2),
                                   config=_packed(bf16))
    for fault in ranks.SP_FAULTS:
        cases[f"sp fault {fault}"] = dict(cases["sp 2x2"], fault=fault)
    for fault in ranks.SP_PACKED_FAULTS:
        cases[f"sp packed fault {fault}"] = dict(cases["sp packed 2x2"],
                                                 fault=fault)
    cases["dcn"] = dict(base, kind="dcn")
    cases["dcn fault"] = dict(base, kind="dcn", fault="cross_slice_skipped")
    cases["flat"] = dict(base, kind="flat")
    cases["refusals"] = dict(base, kind="refusals")
    cases["collectives"] = dict(kind="collectives")
    world = background(launch, ranks.run_cases, 4, cases, device="cpu")
    state = _jax_state(jconf, model, variables)
    refs = {"single bf16": _port_single(bf16, variables, tb, base["t"],
                                        base["noise"]),
            "single packed bf16": _port_single(
                _packed(bf16), variables, tb, base["t"], base["noise"])}
    mesh = jax_sharded.make_hybrid_mesh(8, 2, model_axis="sp")
    for suffix, jc in (("", jconf), (" packed", jpacked)):
        m = models[suffix]
        inner = jax_train_step(m, jc, jit=False)

        def single(state, batch, key, inner=inner, m=m):
            return (*inner(state, batch, key),
                    jax.grad(loss_fn)(state.params, state.batch_stats,
                                      batch, key, m))

        refs["single" + suffix] = _compiled(jax.jit(single), state, jb, key)
        step = jax_sharded.make_sharded_train_step(m, jc, mesh, state,
                                                   mode="sp")
        refs["sp" + suffix] = _compiled(step, jax_sharded.shard_train_state(
            state, mesh, "dp", min_size=1 << 62),
            jax_sharded.shard_graph_batch_nodes(jb, mesh), key)
    for d, sp in set(SP_DIMS.values()):
        shard = jax_sharded.graph_batch_node_sharding(
            jax_sharded.make_hybrid_mesh(d * sp, sp, model_axis="sp"))
        refs[f"sp shapes {d}x{sp}"] = {
            f: tuple(getattr(shard, f).shard_shape(getattr(jb, f).shape))
            for f in SHAPE_FIELDS}
    for mode in ("fsdp", "tp"):
        mesh = jax_sharded.make_hybrid_mesh(8, 4, model_axis=mode)
        step = jax_sharded.make_sharded_train_step(model, jconf, mesh, state,
                                                   mode=mode)
        sstate = jax_sharded.shard_train_state(state, mesh, mode)
        axes = mesh.axis_names if mode == "fsdp" else ("dp",)
        sbatch = jax_sharded.shard_graph_batch_over(jb, mesh, axes)
        refs[mode] = _compiled(step, sstate, sbatch, key)
        two = jax_sharded.make_hybrid_mesh(8, 2, model_axis=mode)
        refs[f"specs {mode}"] = jax_sharded.state_specs(state, two, mode)
    return refs, cases, world()


def _packed(config):
    """`config` (either package's) with packed_pairs on."""
    return dataclasses.replace(config, model=dataclasses.replace(
        config.model, packed_pairs=True))


def _port_single(config, variables, batch, t, noise):
    """The port's single-process step of `config` on the JAX weights:
    (metrics, whole state as sharded.gather_state gives it)."""
    module = ranks.dp.module_of(config.model, variables)
    state = ranks.state_of(config, module)
    metrics = make_train_step(config, "cpu")(state, batch, t, noise)
    return [float(m) for m in metrics], sh.gather_state(state)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _module(conf):
    return DualEncoderEpsNetwork(conf.model)


def _flax(module, name, x):
    """A port tensor as the flax leaf it maps to (kernels transposed)."""
    coll, path = flax_leaf(module, name)
    x = x.numpy()
    return coll, path, (x.T if path[-1] == "kernel" else x)


def _adam_moments(opt_state):
    """{flax path: (mu, nu)} of a JAX optimizer state (both Adams of its
    multi_transform, the masked-out leaves dropped)."""
    out = {}

    def states(tree):
        if hasattr(tree, "mu") and hasattr(tree, "nu"):
            yield tree
        elif isinstance(tree, dict):
            for v in tree.values():
                yield from states(v)
        elif isinstance(tree, tuple):
            for v in tree:
                yield from states(v)

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, prefix + (k,))
        elif isinstance(tree, jax.sharding.PartitionSpec):
            yield prefix, tree
        elif hasattr(tree, "shape"):
            yield prefix, np.asarray(tree)

    for st in states(opt_state):
        mus = dict(leaves(st.mu))
        for path, nu in leaves(st.nu):
            out[path] = (mus[path], nu)
    return out


def _broken(got, ref, module) -> list:
    """The limits (JAX's) that a rank's sharded result `got` breaks
    against a JAX step's (new state, metrics[, grads])."""
    new_state, metrics = ref[0], ref[1]
    broken = []
    if not abs(got["metrics"][0] - float(metrics.loss)) <= \
            LOSS_RTOL * abs(float(metrics.loss)):
        broken.append("loss")
    if not abs(got["metrics"][3] - float(metrics.grad_norm)) <= \
            NORM_RTOL * abs(float(metrics.grad_norm)):
        broken.append("grad_norm")
    moments = _adam_moments(jax.device_get(new_state.opt_state))
    params = jax.device_get(new_state.params)
    st = got["state"]
    for name in st["params"]:
        coll, path, p = _flax(module, name, st["params"][name])
        if not np.allclose(p, _leaf(params, path),
                           rtol=PARAM_RTOL, atol=PARAM_ATOL):
            broken.append(f"param {name}")
        for part, want in zip(("mu", "nu"), moments[path]):
            _, _, m = _flax(module, name, st[part][name])
            if not np.allclose(m, want, rtol=MOMENT_RTOL, atol=MOMENT_ATOL):
                broken.append(f"{part} {name}")
    if len(ref) > 2:
        grads = ref[2]
        top = max(float(np.abs(g).max())
                  for g in jax.tree_util.tree_leaves(grads))
        for name, g in st["grads"].items():
            _, path, g = _flax(module, name, g)
            want = _leaf(grads, path)
            if not np.abs(g - want).max() <= (
                    GRAD_RTOL * np.abs(want).max() + GRAD_FLOOR * top):
                broken.append(f"grad {name}")
    return broken


# ---- the specs --------------------------------------------------------------


@pytest.mark.parametrize("shape,spec", [
    ((), ()),
    ((32,), ()),
    ((32, 64), (None, "fsdp")),
    ((128, 32), ("fsdp", None)),
    ((33, 65), ()),
])
def test_spec_for_array(shape, spec):
    """tests/test_sharded_parallel.py:49-57, each case: JAX's spec and the
    port's, on an array and on a shape."""
    want = jax_sharded.spec_for_array(jnp.zeros(shape), 4, "fsdp")
    assert tuple(want) == spec
    assert sh.spec_for_array(torch.zeros(shape), 4, "fsdp") == spec
    assert sh.spec_for_array(shape, 4, "fsdp") == spec


def _port_specs(conf, axis, leaf_shape=None):
    """The port's specs of a whole state of `conf` over a ('dp', axis)
    mesh of model size 2, by (collection, flax path)."""
    module = DualEncoderEpsNetwork(conf.model)
    state = TrainState(step=0, module=module,
                       optimizer=make_optimizer(module, conf.train),
                       generator=torch.Generator())
    mesh = Mesh(2, 0, torch.device("cpu"), "gloo", axis_names=("dp", axis),
                dims=(1, 2))
    with pytest.MonkeyPatch.context() as mp:
        if leaf_shape is not None:
            mp.setattr(sh, "leaf_shape", leaf_shape)
        specs = sh.state_specs(state, mesh, axis)
    return {"/".join(flax_leaf(module, n)[:1] + flax_leaf(module, n)[1]):
            list(s) for n, s in specs.items()}


def _jax_fixture_specs(name):
    """JAX's specs of a whole TrainState of configs/`name` over a
    ('dp', axis) mesh of model size 2, each axis, by collection/path (the
    state's shapes traced, nothing compiled)."""
    jconf = jax_load_config(os.path.join(ROOT, "configs", name))
    shapes = jax.eval_shape(lambda k: jax_create_train_state(
        jconf, k, max_nodes=32, batch_size=2)[1], jax.random.PRNGKey(0))
    out = {}
    for axis in ("fsdp", "tp"):
        mesh = jax_sharded.make_hybrid_mesh(2, 2, model_axis=axis)
        specs = jax_sharded.state_specs(shapes, mesh, axis)
        flat = {}
        for coll in ("params", "batch_stats"):
            for path, spec in jax.tree_util.tree_flatten_with_path(
                    getattr(specs, coll),
                    is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]:
                keys = [p.key for p in path]
                flat["/".join([coll] + keys)] = list(spec)
        out[axis] = flat
    return out


def write_spec_fixture():
    """Write tests/torch_port_jax_specs.json, JAX's specs that
    chip_smoke.py phase 14 holds the port's against (the card has no
    JAX): python tests/test_torch_port_sharded.py --write-fixture."""
    data = {name: _jax_fixture_specs(name) for name in SPEC_CONFIGS}
    with open(SPEC_FIXTURE, "w") as f:
        json.dump(data, f, indent=0, sort_keys=True)
        f.write("\n")


@pytest.mark.parametrize("name", SPEC_CONFIGS)
def test_spec_fixture_is_jax_and_the_ports(name):
    """The fixture chip_smoke.py reads holds JAX's specs of the config's
    whole state, and the port's specs equal them leaf by leaf; specs
    taken on the port's (out, in) shapes do not (chip_smoke.py's planted
    fault)."""
    with open(SPEC_FIXTURE) as f:
        fixture = json.load(f)[name]
    assert fixture == _jax_fixture_specs(name)
    conf = load_config(os.path.join(ROOT, "configs", name))
    for axis in ("fsdp", "tp"):
        assert _port_specs(conf, axis) == fixture[axis]
        assert any(s for s in fixture[axis].values())
    wrong = _port_specs(conf, "fsdp",
                        leaf_shape=lambda m, n, t: tuple(t.shape))
    assert wrong != fixture["fsdp"]


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
def test_sharded_specs_equal_jax(world, mode):
    """The specs the port's sharded state was cut by equal JAX's leaf by
    leaf at the same model-axis size, the Adam moments and the EMA
    following their parameter's (test_sharded_parallel.py:100-133)."""
    refs, cases, out = world
    module = _module(cases[mode]["config"])
    jax_specs = refs[f"specs {mode}"]
    moments = _adam_moments(jax_specs.opt_state)
    n_split = 0
    for name, spec in out[0][mode]["specs"].items():
        coll, path = flax_leaf(module, name)
        want = getattr(jax_specs, coll)
        for k in path:
            want = want[k]
        assert tuple(want) == spec, name
        if coll == "params":
            assert tuple(moments[path][0]) == tuple(moments[path][1]) == spec
            assert _ema_spec(jax_specs, path) == spec
            n_split += bool(spec)
    assert n_split >= 4


def _ema_spec(specs, path):
    tree = specs.ema_params
    for k in path:
        tree = tree[k]
    return tuple(tree)


def test_sharded_state_layout(world):
    """Each sharded leaf (parameter and both moments) is 1/2 of its whole
    on every rank, the others whole; the cut state gathers back to the
    weights bit for bit (test_sharded_parallel.py:100-133)."""
    _, cases, out = world
    module = _module(cases["fsdp"]["config"])
    whole = dict(module.named_parameters())
    for r in range(4):
        got = out[r]["fsdp"]
        assert got["round_trip"]
        for name, size in got["sizes"].items():
            n = whole[name].numel()
            want = n // 2 if name in got["dims"] else n
            assert size == want and got["moment_sizes"][name] == (want, want)
        held, total = got["bytes"]
        assert held < total
    assert sum(name in out[0]["fsdp"]["dims"] for name in whole) >= 4


def _rank_zero_mesh(axis):
    """Rank 0's view of a ('dp', axis) = (1, 2) mesh, without a world:
    cutting a state and counting its bytes need no collective."""
    cpu = torch.device("cpu")
    lines = {("dp",): Mesh(1, 0, cpu, "gloo", axis_names=("dp",), dims=(1,),
                           members=(0,)),
             (axis,): Mesh(2, 0, cpu, "gloo", axis_names=(axis,), dims=(2,),
                           members=(0, 1))}
    return Mesh(2, 0, cpu, "gloo", axis_names=("dp", axis), dims=(1, 2),
                lines=lines)


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
@pytest.mark.parametrize("name", SPEC_CONFIGS)
def test_full_width_state_per_rank(name, mode):
    """At the widths chip_smoke.py phase 14 shards over two ranks, a rank
    holds at most 0.55 of the state's bytes (parameters, both moments,
    the EMA where the config keeps one, the statistics): the gate the
    card run checks, worked out here."""
    from agdiff_torch.train.train_step import create_train_state

    conf = load_config(os.path.join(ROOT, "configs", name))
    state = create_train_state(conf, "cpu")
    sh.shard_train_state(state, _rank_zero_mesh(mode), mode)
    held, total = state.layout.rank_bytes(state)
    assert 0.5 < held / total <= 0.55


# ---- the steps --------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
@pytest.mark.parametrize("reference", ["single", "sharded"])
def test_sharded_matches_jax(world, mode, reference):
    """The port's sharded step on a (2, 2) mesh against JAX's single step
    and JAX's sharded step on its (2, 4) mesh (test_sharded_parallel.py:
    81-97): loss, gradient norm, moments, parameters (and, against the
    single step, every gradient leaf), on every rank; every rank holds
    the same whole state."""
    refs, cases, out = world
    module = _module(cases[mode]["config"])
    ref = refs["single" if reference == "single" else mode]
    for r in range(4):
        assert _broken(out[r][mode], ref, module) == [], r
    assert out[0][mode]["rows"] == (2 if mode == "fsdp" else 4)
    for part, tensors in out[0][mode]["state"].items():
        for name, x in tensors.items():
            assert torch.equal(x, out[3][mode]["state"][part][name]), \
                (part, name)


@pytest.mark.parametrize("fault", ranks.SHARD_FAULTS)
def test_planted_faults_break_the_limits(world, fault):
    refs, cases, out = world
    module = _module(cases[f"fault {fault}"]["config"])
    assert _broken(out[0][f"fault {fault}"], refs["single"], module)


def test_sp_mode_validation(world):
    """'pp2' and 'sp' on a mesh without an 'sp' axis raise ValueError, as
    in JAX (test_sharded_parallel.py:171-177); on a ('dp', 'sp') mesh the
    step and the batch's node sharding are made; a node axis the 'sp'
    axis does not divide raises ValueError; a packed_pairs config's sp
    step is made (the triangle is split into each rank's owned pairs,
    ops/pairs.py owned_pairs)."""
    _, _, out = world
    got = out[0]["refusals"]
    assert got["pp2"][0] == "ValueError"
    assert got["sp_on_tp"][0] == "ValueError"
    assert got["no_axis"][0] == "ValueError"
    assert got["sp"] is None and got["sp_batch"] is None
    assert got["sp_indivisible"][0] == "ValueError"
    assert got["sp_packed"] is None


@pytest.mark.parametrize("name", list(SP_DIMS))
@pytest.mark.parametrize("reference", ["single", "sp"])
def test_sp_matches_jax(world, name, reference):
    """The port's sp step on ('dp', 'sp') = (2, 2) and (1, 2), and under
    remat, dense and packed_pairs, against JAX's single step and JAX's sp
    step on its (4, 2) mesh of the same layout (test_sharded_parallel.py:
    146-168; GSPMD partitions JAX's triu pack): loss, gradient norm,
    moments, parameters (and, against the single step, every gradient
    leaf), on every rank of the mesh; the ranks' whole states are
    equal."""
    refs, cases, out = world
    module = _module(cases[name]["config"])
    members = 4 if SP_DIMS[name][0] == 2 else 2
    ref = refs[reference + (" packed" if "packed" in name else "")]
    for r in range(members):
        assert _broken(out[r][name], ref, module) == [], r
    for part, tensors in out[0][name]["state"].items():
        for key, x in tensors.items():
            assert torch.equal(x, out[members - 1][name]["state"][part][key]
                               ), (part, key)
    assert all(out[r][name] is None for r in range(members, 4))


@pytest.mark.parametrize("name", list(SP_DIMS))
def test_sp_shard_shapes_equal_jax(world, name):
    """Each field of a rank's sp shard has the shape JAX's
    graph_batch_node_sharding gives it on a mesh of the same shape:
    atom_type and node_mask (b, N/sp), pos (b, N/sp, 3), bond_adj
    (b, N/sp, N), graph_mask (b,)."""
    refs, _, out = world
    d, sp = SP_DIMS[name]
    want = refs[f"sp shapes {d}x{sp}"]
    assert want["bond_adj"] == (B // d, N // sp, N)
    for r in range(d * sp):
        assert out[r][name]["shapes"] == want


@pytest.mark.parametrize("name", ["sp bf16", "sp packed bf16"])
def test_sp_bf16_matches_the_single_step(world, name):
    """The bf16 sp step on (2, 2), dense and packed_pairs, against the
    port's single-process bf16 step of the same layout at chip_smoke.py
    phase 11's limits: the loss terms, the worst gradient leaf over the
    model's largest |g|, the median over leaves of the gradient's
    relative error, the running statistics."""
    refs, _, out = world
    metrics, whole = refs["single" + name[2:]]
    for r in range(4):
        got = out[r][name]
        row = _bf16_errors(got["metrics"], got["state"], metrics, whole)
        assert [k for k, lim in BF16_LIMITS.items() if not row[k] <= lim
                ] == [], (r, row)


def _bf16_errors(mg, sg, mr, sr) -> dict:
    """chip_smoke.py bf16_step_errors on the metrics and whole states."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(mg[:3], mr[:3]))
    top = max(float(g.abs().max()) for g in sr["grads"].values())
    norms = [float((sg["grads"][n] - g).norm()) / max(float(g.norm()), 1e-30)
             for n, g in sr["grads"].items()]
    return dict(
        loss_rel=loss_rel,
        grad_top_rel=max(float((sg["grads"][n] - g).abs().max()) / top
                         for n, g in sr["grads"].items()),
        grad_norm_median=float(np.median(norms)),
        stats_max_rel=max(float((sg["buffers"][n] - b).abs().max())
                          / max(float(b.abs().max()), 1.0)
                          for n, b in sr["buffers"].items()))


@pytest.mark.parametrize("fault", ranks.SP_FAULTS)
def test_sp_planted_faults_break_the_limits(world, fault):
    refs, cases, out = world
    module = _module(cases[f"sp fault {fault}"]["config"])
    assert _broken(out[0][f"sp fault {fault}"], refs["single"], module)


@pytest.mark.parametrize("fault", ranks.SP_PACKED_FAULTS)
def test_sp_packed_planted_faults_break_the_limits(world, fault):
    """The packed sp step's faults (tests/torch_port_shard_ranks.py
    SP_PACKED_FAULTS) against JAX's single packed step."""
    refs, cases, out = world
    name = f"sp packed fault {fault}"
    assert _broken(out[0][name], refs["single packed"],
                   _module(cases[name]["config"]))


def test_sp_packed_pair_counts(world):
    """Each rank of the packed sp steps owns P / sp of the triangle's
    pairs within N, and the ranks of an 'sp' line own P together."""
    _, _, out = world
    p = N * (N - 1) // 2
    for name, (d, sp) in SP_DIMS.items():
        if "packed" in name:
            counts = [out[r][name]["pairs"] for r in range(d * sp)]
            assert sum(counts) == d * p, (name, counts)
            assert max(abs(c - p / sp) for c in counts) <= N, counts


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("n", [16, 32, 33])
def test_pair_ownership_rule(sp, n):
    """ops/pairs.py owned_pairs over the ranks of an 'sp' line of size sp,
    at N = 16, 32 and 33 (padded to the next multiple of sp, as a batch
    must be): every unordered pair is owned exactly once, its endpoint i
    lies in the owner's rows, and each rank holds P / sp pairs within
    N."""
    n = -(-n // sp) * sp
    k = n // sp
    owned = {}
    for rank in range(sp):
        nodes = SimpleNamespace(n=n, k=k, rows=slice(rank * k, rank * k + k))
        share = owned_pairs(nodes, "cpu")
        i, j = share.i.numpy(), share.j.numpy()
        assert ((i >= rank * k) & (i < rank * k + k)).all()
        assert (share.cell.numpy() == (i - rank * k) * n + j).all()
        owned[rank] = {(min(a, b), max(a, b)) for a, b in zip(i, j)}
        assert len(owned[rank]) == len(i)
    p = n * (n - 1) // 2
    assert sum(len(v) for v in owned.values()) == p
    assert set().union(*owned.values()) == {
        (a, b) for a in range(n) for b in range(a + 1, n)}
    assert max(abs(len(v) - p / sp) for v in owned.values()) <= n


def test_hybrid_mesh_validation(world):
    """test_sharded_parallel.py:136-143 on a world of four: a count the
    model axis does not divide and more devices than the world raise; a
    ('dp', 'tp') mesh of (2, 2) with its model lines (2i, 2i + 1)."""
    _, _, out = world
    for r in range(4):
        got = out[r]["refusals"]
        assert got["indivisible"][0] == "ValueError"
        assert got["too_many"][0] == "ValueError"
        names, shape, members = got["tp_mesh"]
        assert names == ("dp", "tp") and shape == {"dp": 2, "tp": 2}
        assert members == (2 * (r // 2), 2 * (r // 2) + 1)


# ---- the multi-slice mesh and the 1-D mesh ----------------------------------


def test_dcn_mesh_train_step(world):
    """The DP step over the ('dcn', 'dp') = (2, 2) mesh against JAX's
    single step (tests/test_train_eval.py:751-776, rtol 1e-5), and every
    gradient leaf; its lines: ranks (0, 2) and (1, 3) across slices, (0,
    1) and (2, 3) within."""
    refs, cases, out = world
    module = _module(cases["dcn"]["config"])
    want = refs["single"]
    for r in range(4):
        got = out[r]["dcn"]
        assert got["axis_names"] == ("dcn", "dp")
        assert got["shape"] == {"dcn": 2, "dp": 2}
        assert got["lines"] == {"dcn": (r % 2, r % 2 + 2),
                                "dp": (2 * (r // 2), 2 * (r // 2) + 1)}
        np.testing.assert_allclose(got["metrics"][0], float(want[1].loss),
                                   rtol=LOSS_RTOL)
    top = max(float(np.abs(g).max())
              for g in jax.tree_util.tree_leaves(want[2]))
    for name, g in out[0]["dcn"]["grads"].items():
        _, path, g = _flax(module, name, g)
        ref = _leaf(want[2], path)
        assert np.abs(g - ref).max() <= \
            GRAD_RTOL * np.abs(ref).max() + GRAD_FLOOR * top, name
    # the cross-slice level skipped: each slice keeps its own gradient
    wrong = out[0]["dcn fault"]["grads"]
    assert any(not torch.allclose(wrong[n], out[0]["dcn"]["grads"][n],
                                  rtol=1e-3, atol=1e-3) for n in wrong)


def test_dcn_refusals(world):
    """make_mesh: slices that do not divide the world, and a device count
    other than the world's, raise ValueError."""
    _, _, out = world
    got = out[0]["refusals"]
    assert got["dcn_indivisible"][0] == "ValueError"
    assert got["dcn_world"][0] == "ValueError"


def test_one_dimensional_mesh_step_is_unchanged(world):
    """make_mesh(4)'s DP step is torch.equal to the step over the world's
    group built directly as a 1-D Mesh: parameters, gradients,
    statistics."""
    _, _, out = world
    for r in range(4):
        mesh, old = out[r]["flat"]
        assert mesh["metrics"] == old["metrics"]
        for part in ("params", "grads", "buffers"):
            for name, x in mesh[part].items():
                assert torch.equal(x, old[part][name]), (part, name)


# ---- the collectives --------------------------------------------------------


def test_all_gather_and_reduce_scatter(world):
    """all_gather stacks every rank's tensor (f32 and bf16, and over a
    mesh line), its backward reduce-scatters; reduce_scatter gives this
    rank's row of the sum, its backward all-gathers."""
    _, _, out = world
    xs = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
          for r in range(4)]
    stacked = [torch.arange(24, dtype=torch.float32).reshape(4, 2, 3)
               * (r + 1) for r in range(4)]
    w = torch.arange(24, dtype=torch.float32).reshape(4, 2, 3) + 1.0
    for r in range(4):
        got = out[r]["collectives"]
        assert torch.equal(got["gathered"], torch.stack(xs))
        assert torch.equal(got["bf16"], torch.stack(xs).bfloat16())
        # d/dx_r of sum over ranks q of sum(w * gather): 4 w[r]
        assert torch.equal(got["gather_grad"], 4 * w[r])
        assert torch.equal(got["scattered"], sum(stacked)[r])
        # d/dstacked of sum over ranks q of (q + 1) * row q of the sum
        assert torch.equal(got["scatter_grad"], torch.stack(
            [torch.full((2, 3), float(q + 1)) for q in range(4)]))
        line = (2 * (r // 2), 2 * (r // 2) + 1)
        assert got["line_members"] == line
        assert torch.equal(got["line"], torch.stack([xs[q] for q in line]))


def test_ppermute(world):
    """ppermute moves each rank's tensor along the permutation (zeros
    where no rank sends), its backward along the inverse."""
    _, _, out = world
    xs = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
          for r in range(4)]
    for r in range(4):
        got = out[r]["collectives"]
        assert torch.equal(got["permuted"], xs[(r - 1) % 4])
        # rank r's x lands on rank r + 1, whose loss weighs it r + 2
        assert torch.equal(got["permute_grad"],
                           torch.full((2, 3), float((r + 1) % 4 + 1)))
        want = {0: xs[1], 2: xs[0]}.get(r, torch.zeros(2, 3))
        assert torch.equal(got["partial"], want)


if __name__ == "__main__" and "--write-fixture" in sys.argv:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    jax.config.update("jax_platforms", "cpu")
    write_spec_fixture()
