"""Engine 'mono' of the port against the JAX package: `prepare_weights`
against `_prepare_weights` key by key, K6's plain version (through the
mono forward) against JAX's build_monolithic_forward with the Pallas
kernel in interpret mode, the configurations JAX refuses, the
working-graph switches (extend_order, extend_radius) on every forward, a
mono ladder, and the runner's engine choice.

Sizes as tests/test_monolithic.py: hidden 32, 2 + 2 convs, bucket 16,
B <= 4. At f32 the bar is JAX's own, 2e-4 absolute on the masked score
planes (tests/test_monolithic.py:46-51); at bf16 both round at the same
points, and a product summed in another order can flip a bf16 rounding
that later layers carry on: the largest difference stays within 1e-2 of
the plane's largest score and the median within 1e-4 of it."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agdiff_tpu.models.dualenc import get_model
from agdiff_tpu.models.fast_forward import build_fast_forward as jax_fast
from agdiff_tpu.models.schedules import make_diffusion as jax_diffusion
from agdiff_tpu.ops.graph import (
    extend_graph_order_dense as jax_extend,
)
from agdiff_tpu.ops.pallas import monolithic as jax_mono
from agdiff_tpu.sampling.langevin import (
    SamplerConfig as JaxSamplerConfig,
    langevin_dynamics_sample as jax_ld,
)

from agdiff_torch.data.bucketing import pad_molecules
from agdiff_torch.data.fixture import load_fixture
from agdiff_torch.eval.generate import GenerationRunner
from agdiff_torch.kernels import monolithic as k6
from agdiff_torch.models.fast_forward import build_fast_forward
from agdiff_torch.models.mono_forward import (
    MonoForward,
    build_monolithic_forward,
)
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.ops.graph import extend_graph_order_dense
from agdiff_torch.sampling.langevin import SamplerConfig, build_fast_sampler

from test_torch_port_common import (
    FAST_XLA,
    batches,
    configs,
    jax_run,
    jax_variables,
    molecules,
    port_model,
    row_product,
)

F32_TOL = 2e-4
BF16_MAX, BF16_MEDIAN = 1e-2, 1e-4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jax_mono, "_INTERPRET", True)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = configs()
    mols = molecules(4, seed=9)
    jb, tb = batches(mols, 16)
    _, variables = jax_variables(jcfg, jb)
    return jcfg, cfg, mols, jb, tb, variables, port_model(cfg, variables)


def _masks_equal(out, ref):
    for name in ("edge_mask", "local_mask", "edge_type"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def _planes(out, ref):
    for name, mask in (("edge_inv_global", ref.edge_mask),
                       ("edge_inv_local", ref.local_mask)):
        m = np.asarray(mask)
        assert m.any(), name
        yield (name, m, np.where(m, getattr(out, name).float().numpy(), 0),
               np.where(m, np.asarray(getattr(ref, name), np.float32), 0))


def _compare_f32(out, ref, tol=F32_TOL):
    _masks_equal(out, ref)
    for name, _, got, want in _planes(out, ref):
        np.testing.assert_allclose(got, want, atol=tol, err_msg=name)


def _raw_adjacency(jb, tb, mols):
    """The batches with the raw (unextended) bond adjacency."""
    raw = np.zeros(np.asarray(jb.bond_adj).shape, np.int32)
    for k, m in enumerate(mols):
        n = m.num_nodes
        raw[k, :n, :n] = m.bond_adjacency()
    return (jb.replace(bond_adj=jnp.asarray(raw)),
            tb.replace(bond_adj=torch.from_numpy(raw.astype(np.int64))))


# ---- prepare_weights --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepare_weights_matches_jax(setup, dtype):
    """The same keys, shapes and dtypes; f32 entries within 1e-5 relative
    (BatchNorm folds and the type tables' products in another library),
    cd entries at bf16 within one bf16 unit (2^-8 relative), which such a
    difference can flip."""
    jcfg, cfg, _, _, _, variables, model = setup
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    ref = jax_mono._prepare_weights(jcfg, variables, jd)
    got = k6.prepare_weights(cfg, model, td)
    assert set(got) == set(ref)
    for key, want in ref.items():
        want = np.asarray(want.astype(jnp.float32))
        g = got[key]
        assert tuple(g.shape) == want.shape, key
        cd_key = key in k6.MATMUL_KEYS
        assert g.dtype == (td if cd_key else torch.float32), key
        rtol = 2.0 ** -8 if cd_key and dtype == "bfloat16" else 1e-5
        np.testing.assert_allclose(g.float().numpy(), want, rtol=rtol,
                                   atol=1e-6, err_msg=key)


# ---- the mono forward against JAX's -----------------------------------------

VARIANTS = {
    "default": ({}, {}),
    "smooth_conv": (dict(smooth_conv=True), {}),
    "gelu_heads": (dict(mlp_act="gelu"), {}),
    "bond_graph_only": ({}, dict(extend_radius=False)),
    "extend_order_raw": ({}, dict(extend_order=True)),
    "batch_of_3": ({}, {}),
}


@pytest.fixture(scope="module")
def references(setup):
    """JAX references that several tests read, each computed once: the
    f32 kernel (interpret mode) compiled for the fixture's batch shape,
    the kernel with extend_radius=False and with extend_order=True on the
    raw bonds (one program), and the dense module with
    extend_radius=False."""
    jcfg, _, mols, jb, tb, variables, _ = setup
    fn = jax_mono.build_monolithic_forward(
        jcfg, variables, compute_dtype=jnp.float32, tile=2, interpret=True)
    kernel = jax.jit(fn).lower(jb).compile(compiler_options=FAST_XLA)
    bond_graph, raw_order = jax_run(
        lambda a, raw: (fn(a, extend_radius=False),
                        fn(raw, extend_order=True)),
        jb, _raw_adjacency(jb, tb, mols)[0])
    module = jax_run(functools.partial(
        get_model(jcfg).apply, variables, train=False, extend_radius=False),
        jb)
    return {"kernel": kernel, "default": kernel(jb),
            "bond_graph_only": bond_graph, "extend_order_raw": raw_order,
            "module_bond_graph": module}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mono_matches_jax_f32(setup, references, variant):
    """K6's plain version through the mono forward at f32 against JAX's
    kernel in interpret mode: masked planes within 2e-4, masks and edge
    types equal. 'bond_graph_only' and 'extend_order_raw' call both with
    the same option ('extend_order_raw' on the raw bonds); 'batch_of_3'
    reads the first three graphs of the kernel on its molecules padded to
    the fixture's four graphs (graphs do not interact)."""
    jcfg, cfg, mols, jb, tb, variables, model = setup
    over, call = VARIANTS[variant]
    if over:
        jcfg = dataclasses.replace(jcfg, **over)
        cfg = dataclasses.replace(cfg, **over)
        model = port_model(cfg, variables)
        ref = jax_run(jax_mono.build_monolithic_forward(
            jcfg, variables, compute_dtype=jnp.float32, tile=2), jb)
    elif variant == "batch_of_3":
        mols = molecules(3, seed=2)
        padded = batches(mols, 16, batch_size=jb.pos.shape[0])[0]
        tb = batches(mols, 16)[1]
        ref = jax.tree_util.tree_map(lambda a: a[:3],
                                     references["kernel"](padded))
    else:
        ref = references[variant if call else "default"]
        if call.get("extend_order"):
            _, tb = _raw_adjacency(jb, tb, mols)
    fwd = build_monolithic_forward(cfg, model, torch.float32)
    out = fwd(tb, **call)
    assert fwd.calls == 1 and k6.launches == {}
    _compare_f32(out, ref)


def test_mono_matches_jax_bf16(setup):
    jcfg, cfg, _, jb, tb, variables, model = setup
    ref = jax_run(jax_mono.build_monolithic_forward(
        jcfg, variables, compute_dtype=jnp.bfloat16, tile=2), jb)
    fwd = build_monolithic_forward(dataclasses.replace(cfg, dtype="bfloat16"),
                                   model)
    assert fwd.compute_dtype == torch.bfloat16
    out = fwd(tb)
    _masks_equal(out, ref)
    for name, m, got, want in _planes(out, ref):
        scale = np.abs(want).max()
        diff = np.abs(got - want)[m]
        assert diff.max() <= BF16_MAX * scale, (name, diff.max(), scale)
        assert np.median(diff) <= BF16_MEDIAN * scale, name


def test_mono_f32_matches_the_f32_engine(setup):
    _, cfg, _, _, tb, _, model = setup
    ref = build_fast_forward(cfg, model, None)(tb)
    out = build_monolithic_forward(cfg, model)(tb)
    for name, mask in (("edge_inv_global", ref.edge_mask),
                       ("edge_inv_local", ref.local_mask)):
        np.testing.assert_allclose(
            torch.where(mask, getattr(out, name), 0).numpy(),
            torch.where(mask, getattr(ref, name), 0).numpy(), atol=F32_TOL,
            err_msg=name)


@pytest.mark.parametrize("over", [dict(edge_encoder="gaussian"),
                                  dict(edge_attention_mode="sigmoid"),
                                  dict(tie_edge_encoders=False)])
def test_refused_configurations_raise(setup, over):
    """What JAX's build_monolithic_forward refuses (monolithic.py:80-84,
    :396-401), the port refuses."""
    jcfg, cfg, _, jb, _, variables, model = setup
    jcfg = dataclasses.replace(jcfg, **over)
    jvars = variables
    if over.get("tie_edge_encoders") is False:
        # the refusal reads the variables' names only: their shapes do
        jvars = jax.eval_shape(lambda k: get_model(jcfg).init(
            k, jb, train=False), jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError):
        jax_mono.build_monolithic_forward(jcfg, jvars)(jb)
    with pytest.raises(NotImplementedError):
        build_monolithic_forward(dataclasses.replace(cfg, **over), model)


# ---- the working graph ------------------------------------------------------

@pytest.mark.parametrize("order", [2, 3])
def test_extend_graph_order_dense_matches_jax(order):
    rng = np.random.default_rng(order)
    adj = rng.integers(1, 5, size=(3, 12, 12)) * (rng.random((3, 12, 12))
                                                  < 0.2)
    adj = np.triu(adj, 1)
    adj = (adj + adj.transpose(0, 2, 1)).astype(np.int32)
    want = np.asarray(jax_run(functools.partial(jax_extend, order=order),
                              jnp.asarray(adj)))
    got = extend_graph_order_dense(torch.from_numpy(adj), order=order)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 22).any()   # k-hop edges were added


@pytest.mark.parametrize("path", ["module", "packed"])
def test_bond_graph_only_matches_jax(setup, references, path):
    """extend_radius=False on the dense module and on the f32 packed
    engine, against their JAX counterparts."""
    jcfg, cfg, _, jb, tb, variables, model = setup
    if path == "module":
        ref = references["module_bond_graph"]
        with torch.no_grad():
            out = model(tb, extend_radius=False)
    else:
        ref = jax_run(functools.partial(jax_fast(
            jcfg, variables, use_pallas=False), extend_radius=False), jb)
        out = build_fast_forward(cfg, model, None)(tb, extend_radius=False)
    np.testing.assert_array_equal(out.edge_mask.numpy(),
                                  np.asarray(ref.local_mask))
    _compare_f32(out, ref)


# ---- a ladder and the runner ------------------------------------------------

def test_mono_ladder_matches_jax_with_replayed_noise(setup):
    """Three f32 ladder steps on mono against JAX's
    langevin_dynamics_sample(forward_fn=mono), the same noise fed to
    both."""
    jcfg, cfg, _, jb, tb, variables, model = setup
    steps = 3
    ladder = dict(n_steps=steps, step_lr=2e-4, w_global=0.3,
                  global_start_sigma=10.0, clip=5.0, clip_local=4.0)
    rng = np.random.default_rng(3)
    pos_init = rng.normal(size=tb.pos.shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = jax_run(functools.partial(
        jax_ld, None, None, diffusion=jax_diffusion(jcfg),
        config=JaxSamplerConfig(**ladder),
        forward_fn=jax_mono.build_monolithic_forward(
            jcfg, variables, compute_dtype=jnp.float32, tile=2)),
        jb, jnp.asarray(pos_init), key)
    noise = []
    for _ in range(steps):
        key, noise_key = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(
            noise_key, tb.pos.shape, jnp.float32)))
    fwd = build_monolithic_forward(cfg, model)
    got = build_fast_sampler(fwd, make_diffusion(cfg), SamplerConfig(
        **ladder))(tb, torch.from_numpy(pos_init),
                   noise=torch.from_numpy(np.stack(noise)))
    assert fwd.calls == steps
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               atol=1e-4)


def test_runner_runs_mono_at_every_bucket(setup):
    """engine='mono' at bucket 16 and at 48 (where the automatic choice is
    a tight engine), with no capacity: samplers keyed (mono, retry,
    None)."""
    _, cfg, _, _, _, _, model = setup
    runner = GenerationRunner(model, cfg, make_diffusion(cfg),
                              SamplerConfig(n_steps=2, w_global=0.3),
                              buckets=(16, 48), chunk_size=4, device="cpu",
                              engine="mono")
    auto = GenerationRunner(model, cfg, make_diffusion(cfg), SamplerConfig(),
                            device="cpu")
    assert auto._engine_for(48) == "tight"
    big = load_fixture("drugs_synthetic")[0]
    for bucket in (16, 48):
        assert runner._engine_for(bucket) == "mono"
        assert runner._capacity_for(big, "mono") is None
    small = molecules(1, seed=5)[0]
    out = runner.run([small], num_confs=3)
    assert out[0].meta["pos_gen"].shape == (3, small.num_nodes, 3)
    fwd = runner.forward("mono")
    assert isinstance(fwd, MonoForward) and fwd.calls == 2
    assert set(runner._samplers) == {("mono", False, None)}
    wide = GenerationRunner(model, cfg, make_diffusion(cfg),
                            SamplerConfig(n_steps=1), buckets=(48,),
                            chunk_size=4, device="cpu", engine="mono")
    res = wide.run([small], num_confs=2)[0].meta["pos_gen"]
    assert np.isfinite(res).all() and wide.forward("mono").calls == 1
    assert wide._bucket_for(small) == 48


# ---- K6 walks only the working graph's pairs ---------------------------------

def _fixture_inputs(setup, case, dtype):
    """K6's inputs on a fixture bucket at 6 A positions (numpy, seeded):
    QM9 (bucket 32) or Drugs (bucket 64, the two molecules that fit),
    with em = lm ('bond_graph_only') or one graph's masks zeroed
    ('empty_graph')."""
    _, cfg, _, _, _, _, model = setup
    drugs = case == "drugs"
    mols = (load_fixture("drugs_synthetic")[:2] if drugs
            else load_fixture())
    batch = pad_molecules(mols, 64 if drugs else 32)
    rng = np.random.default_rng(len(case))
    pos = torch.from_numpy(6.0 * rng.standard_normal(
        tuple(batch.pos.shape)).astype(np.float32))
    batch = batch.replace(pos=pos * batch.node_mask[..., None])
    fwd = build_monolithic_forward(cfg, model, dtype)
    kw, _ = fwd.kernel_inputs(batch,
                              extend_radius=case != "bond_graph_only")
    if case == "empty_graph":
        for key in ("em", "lm"):
            kw[key] = kw[key].clone()
            kw[key][1] = 0.0
    return kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["qm9", "drugs", "bond_graph_only",
                                  "empty_graph"])
def test_plain_over_working_pairs_equals_the_triangle(setup, case, dtype,
                                                      monkeypatch):
    """What K6's compaction rests on: graph by graph (B = 1), the plain
    twin over the graph's working pairs alone (em or lm nonzero, in pair
    order) gives the bits of the twin over the whole triangle on those
    pairs, and the triangle's planes are 0 off them. Off the list every
    message is +-0 and both heads are multiplied by 0; lm is a subset of
    em. Covers em = lm, a graph with no working pair and working counts
    that are not multiples of 32 or 64. Products are row-independent
    (row_product) in both runs."""
    torch.set_num_threads(2)
    monkeypatch.setattr(torch.Tensor, "__matmul__", row_product)
    kw = _fixture_inputs(setup, case, dtype)
    assert bool(((kw["lm"] != 0) <= (kw["em"] != 0)).all())
    if case == "bond_graph_only":
        assert torch.equal(kw["em"], kw["lm"])
    lists = k6.working_pairs(kw["em"], kw["lm"])
    counts = [len(w) for w in lists]
    assert any(c % 32 for c in counts) and any(c % 64 for c in counts)
    assert (0 in counts) == (case == "empty_graph")
    for g, keep in enumerate(lists):
        one = {k: (v[g:g + 1] if isinstance(v, torch.Tensor) else v)
               for k, v in kw.items()}
        full = k6.mono_forward_plain(**one)
        # the list, then pair 0 with em = lm = 0 to a multiple of 64
        # entries, as K6 pads its last tile with rows that add nothing
        # (so that no CPU vector loop leaves a scalar tail either)
        idx = torch.cat([keep, keep.new_zeros(-len(keep) % 64)])
        cut = dict(one, pairs=dataclasses.replace(
            kw["pairs"], iu=kw["pairs"].iu[idx], ju=kw["pairs"].ju[idx]))
        for key in ("dp", "em", "lm", "tp"):
            cut[key] = one[key][:, idx]
            if key in ("em", "lm"):
                cut[key][:, len(keep):] = 0.0
        part = k6.mono_forward_plain(**cut)
        for plane, got in zip(full, part):
            assert torch.equal(plane[:, keep], got[:, :len(keep)]), (case, g)
            off = torch.ones(plane.shape[1], dtype=torch.bool)
            off[keep] = False
            assert bool((plane[:, off] == 0).all())


@pytest.mark.parametrize("n,itemsize,want", [
    (32, 2, (0, 166016, 0)), (32, 4, (0, 173952, 0)),
    (64, 2, (1, 164832, 100352)), (64, 4, (1, 155872, 134144)),
    (96, 2, (1, 224320, 150528))])
def test_layout_and_working_lists_at_the_main_widths(n, itemsize, want):
    """Pinned sums at H = 128 (csrc/mono.cu mirrors them): the layout
    level (the smallest that fits), the launch's shared memory (the
    working lists included where they fit) and the scratch per graph; at
    N = 112 (bf16, level 1) the lists do not fit beside the regions and go
    to the scratch after the node temporaries."""
    assert k6.layout(n, 128, itemsize) == want
    assert want[1] <= k6.MAX_SMEM
    assert k6.lists_bytes(32) == 5232 and k6.lists_bytes(112) == 64192
    assert k6.launch_bytes(112, 128, 2, 1) == (193796, 175616 + 64256)
