"""The CUDA kernels against their plain versions, on a card of compute
capability 9.0 or newer; skips elsewhere. K1: mode 'full' over triu sets,
and every variant over tight lists, at N = 64 (node regions in shared
memory), 96 (node temporaries in global memory) and 192 (all node regions
in global memory); each main-path case at a cluster of R = 1, 2 and 4
CTAs per graph, the layout levels at R = 2, the choice of R and a refused
R. K2-K5: each variant on the inputs its engine gives it
at a small width, and the inputs their wrappers refuse; K3 at bf16 at N =
20 and 40 (ragged 64-pair tiles) and B = 1, K3 at f32 (persistent, 64-pair
tiles) at N = 20, 40 and B = 1, K2 at bf16 at N = 104 (layout level 1),
both called directly at widths that are not multiples of 16, and every
layout level of each giving the same bits. K4 over its masked pairs on
both heads' inputs, at N = 20, 40, 64, 128 and B = 1, with an asymmetric
mask and e, every real pair and an empty graph, every layout level and
CTAs-per-graph R giving the same bits. K6 at small and full width,
with em all ones, em = lm, a graph with no working pair and N = 20, 40,
every layout level giving the same bits. Gelu score heads: K1 (triu
and tight, exact and '-approx'), K4 (f32 and bf16, both heads) and K6
(QM9 bf16 and f32, Drugs bf16) against their plain versions under the
relu forms' limits, with relu heads (and the exact gelu under
'-approx') as faults that must miss them. Data parallelism: two gloo
ranks on card 0, the train step against the single-process step and a
'pksf' ladder against single-process runs at each rank's batch size.
Pipelines: K3 in parallel/pipeline.py's SchNet stage body against the
same body on K3's plain version, and K3 refusing a gradient.
Imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from agdiff_torch.config import ModelConfig
from agdiff_torch.data.bucketing import pad_molecules
from agdiff_torch.data.fixture import load_fixture
from agdiff_torch.kernels import stack_packed as k1
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.fast_forward import build_fast_forward
from agdiff_torch.models.tight_forward import build_tight_forward
from agdiff_torch.models.weights import init_random
from agdiff_torch.ops.pairs import pair_capacity_for

# f32 sums taken in another order than the plain version's can flip a bf16
# rounding by one unit (2^-8 relative), which later layers carry on; the
# median error stays at summation-order noise. Each output (score plane,
# or h / hl over real nodes) is held, as a share of its own largest value,
# to the limits of chip_smoke.py's K1_LIMITS: max error 3%, median 1e-6,
# 99th percentile 3e-3.
BF16_MAX, BF16_MEDIAN, BF16_P99 = 3e-2, 1e-6, 3e-3
# Drugs-sized graphs, per output, chip_smoke.py's DRUGS_LIMITS (max,
# median, p99): there a flipped rounding reaches every atom of its graph
# within a SchNet block, so the global branch differs by more.
DRUGS = {"global": (3e-2, 8e-4, 6e-3), "local": (0.12, 1e-6, 3e-2),
         "h": (5e-4, 2e-5, 1e-4), "hl": (1e-2, 1e-6, 3e-3)}


def _within_limits(got, ref, limits=(BF16_MAX, BF16_MEDIAN, BF16_P99)):
    scale = float(ref.abs().max())
    err = (got - ref).abs().flatten()
    assert torch.isfinite(got).all()
    assert float(err.max()) <= limits[0] * scale
    assert float(err.median()) <= limits[1] * scale
    p99 = err.kthvalue(max(1, int(0.99 * err.numel()))).values
    assert float(p99) <= limits[2] * scale


@pytest.fixture
def card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(32, 16), (64, 8)])
def test_cuda_kernel_matches_plain(card, n, b):
    cfg = dataclasses.replace(ModelConfig(), num_convs=3, num_convs_local=2,
                              dtype="bfloat16")
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    fwd = build_fast_forward(cfg, model, "pksf")
    mols = load_fixture()
    batch = pad_molecules([mols[i % len(mols)] for i in range(b)], n,
                          device=card)
    kw, _ = fwd.stack_inputs(batch)
    before = k1.launches["stack_full:triu"]
    got = k1.packed_stack_forward(**kw)
    assert k1.launches["stack_full:triu"] == before + 1
    ref = k1.packed_stack_forward_plain(**kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        _within_limits(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("engine,n", [
    ("tight-pks", 64), ("tight-pksg", 64), ("tight-pksf", 64),
    ("tight-pksf-approx", 64), ("tight-pksf", 96), ("tight-pksg", 192)])
def test_cuda_tight_variants_match_plain(card, engine, n):
    """Each variant on a Drugs-sized molecule's tight list (pad slots
    included), outputs against the plain version: planes on every slot,
    node states on real nodes."""
    cfg = dataclasses.replace(ModelConfig(), num_convs=3, num_convs_local=2,
                              dtype="bfloat16", smooth_conv=True)
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    fwd = build_tight_forward(cfg, model, engine)
    mol = load_fixture("drugs_synthetic")[3 if n > 64 else 0]
    batch = pad_molecules([mol] * 4, n, device=card)
    pairs = fwd.prepare(batch, pair_capacity_for(mol.num_nodes, 256))
    assert pairs.num_valid < pairs.num_pairs
    kw, _ = fwd.stack_inputs(batch, pairs)
    name = k1.variant(fwd.mode, fwd.approx, True)
    before = k1.launches[name]
    got = k1.packed_stack_forward(**kw, mode=fwd.mode, approx=fwd.approx)
    assert k1.launches[name] == before + 1
    ref = k1.packed_stack_forward_plain(**kw, mode=fwd.mode,
                                        approx=fwd.approx)
    torch.cuda.synchronize()
    names = {"full": ("global", "local"), "gin": ("h", "hl"),
             "schnet": ("h",)}[fwd.mode]
    if fwd.mode == "schnet":
        got, ref = (got,), (ref,)
    real = batch.node_mask
    for name, g, r in zip(names, got, ref):
        if fwd.mode != "full":
            g, r = g[real], r[real]
        _within_limits(g, r, DRUGS[name])


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(card):
    cfg = dataclasses.replace(ModelConfig(), num_convs=1, num_convs_local=1,
                              dtype="bfloat16")
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    fwd = build_fast_forward(cfg, model, "pksf")
    batch = pad_molecules(load_fixture()[:2], 32, device=card)
    kw, _ = fwd.stack_inputs(batch)
    f32 = dict(kw, e_packed=kw["e_packed"].float(),
               e_packed_local=kw["e_packed_local"].float())
    with pytest.raises(TypeError):
        k1.packed_stack_forward(**f32)
    with pytest.raises(ValueError):
        k1.packed_stack_forward(**dict(kw, h0=kw["h0"][:, :16]))
    with pytest.raises(TypeError):   # f32 kernel modes are not built
        k1.packed_stack_forward(**f32, mode="schnet")


# K1 split across a cluster of R CTAs per graph (`ranks`): each R sums the
# ranks' partial node sums in its own order, so each is held to the limits
# above against the plain version, not to another R's bits.
K1_CASES = {   # label: (engine, N, B); triu cases run engine 'pksf'
    "triu_B128_N32": ("pksf", 32, 128), "triu_B48_N64": ("pksf", 64, 48),
    "tight_N64": ("tight-pksf", 64, 48), "tight_N80": ("tight-pksf", 80, 48),
    "tight_N96": ("tight-pksf", 96, 48),
    "tight_N128": ("tight-pksf", 128, 48),
    "schnet_N64": ("tight-pks", 64, 48), "gin_N64": ("tight-pksg", 64, 48),
    "full_approx_N64": ("tight-pksf-approx", 64, 48)}


# gelu score heads (config mlp_act 'gelu'), exact and '-approx'
GELU_K1_CASES = {
    "gelu_triu_B128_N32": ("pksf", 32, 128),
    "gelu_approx_triu_B128_N32": ("pksf-approx", 32, 128),
    "gelu_tight_N64": ("tight-pksf", 64, 48),
    "gelu_approx_tight_N64": ("tight-pksf-approx", 64, 48)}


def _k1_case(card, label):
    """(kw, mode, approx, real-node mask, limits by output) of a K1 case
    at H = 128 (3 SchNet blocks, 2 GIN layers): the QM9 molecules over
    the triu set, or a Drugs molecule's tight list (N = 128: two of them
    in one graph, as chip_smoke.py's union); the GELU_K1_CASES with gelu
    score heads."""
    import numpy as np

    from agdiff_torch.chem.mol import Molecule

    gelu = label in GELU_K1_CASES
    engine, n, b = (GELU_K1_CASES if gelu else K1_CASES)[label]
    tight = engine.startswith("tight")
    cfg = dataclasses.replace(ModelConfig(), num_convs=3, num_convs_local=2,
                              dtype="bfloat16", smooth_conv=tight,
                              mlp_act="gelu" if gelu else "relu")
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    if not tight:
        mols = load_fixture()
        batch = pad_molecules([mols[i % len(mols)] for i in range(b)], n,
                              device=card)
        fwd = build_fast_forward(cfg, model, engine)
        kw, _ = fwd.stack_inputs(batch)
        return kw, "full", fwd.approx, batch.node_mask, None
    drugs = load_fixture("drugs_synthetic")
    mol = drugs[0] if n == 64 else drugs[3]
    if n == 128:
        m1, m2 = drugs[0], drugs[2]
        mol = Molecule(
            atom_type=np.concatenate([m1.atom_type, m2.atom_type]),
            pos=np.concatenate([m1.pos, m2.pos + np.float32([6, 0, 0])]),
            bond_index=np.concatenate([m1.bond_index,
                                       m2.bond_index + m1.num_nodes], 1),
            bond_type=np.concatenate([m1.bond_type, m2.bond_type]))
    fwd = build_tight_forward(cfg, model, engine)
    batch = pad_molecules([mol] * b, n, device=card)
    pairs = fwd.prepare(batch, pair_capacity_for(mol.num_nodes, 256))
    kw, _ = fwd.stack_inputs(batch, pairs)
    return kw, fwd.mode, fwd.approx, batch.node_mask, DRUGS


def _k1_outputs(out, mode):
    return (out,) if mode == "schnet" else tuple(out)


def _k1_within_limits(got, ref, mode, real, limits):
    names = {"full": ("global", "local"), "gin": ("h", "hl"),
             "schnet": ("h",)}[mode]
    for name, g, r in zip(names, _k1_outputs(got, mode),
                          _k1_outputs(ref, mode)):
        if mode != "full":
            g, r = g[real], r[real]
        if limits is None:
            _within_limits(g, r)
        else:
            _within_limits(g, r, limits[name])


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("label", list(K1_CASES))
def test_cuda_k1_ranks_match_plain(card, label, ranks):
    """Each K1 case at a forced cluster size R against the plain version,
    one launch counted per call; two launches at one R give the same
    bits."""
    kw, mode, approx, real, limits = _k1_case(card, label)
    name = k1.variant(mode, approx, kw["pairs"].tight)
    before = k1.launches[name]
    got = k1.packed_stack_forward(**kw, mode=mode, approx=approx,
                                  ranks=ranks)
    assert k1.launches[name] == before + 1
    assert k1.last_launch["ranks"] == ranks
    again = k1.packed_stack_forward(**kw, mode=mode, approx=approx,
                                    ranks=ranks)
    ref = k1.packed_stack_forward_plain(**kw, mode=mode, approx=approx)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(
        _k1_outputs(got, mode), _k1_outputs(again, mode)))
    _k1_within_limits(got, ref, mode, real, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["tight_N64", "tight_N96"])
def test_cuda_k1_layout_levels_at_two_ranks(card, label):
    """At R = 2 every layout level that fits gives the bits of the
    wrapper's level (peers' sums through distributed shared memory at
    level 0, through their scratch above it)."""
    kw, mode, approx, real, limits = _k1_case(card, label)
    n, h = kw["h0"].shape[1:]
    ref = k1.packed_stack_forward(**kw, ranks=2)
    levels = [lv for lv in (0, 1, 2) if k1.smem_bytes(n, h, lv) <= k1.MAX_SMEM]
    assert len(levels) >= 2
    for level in levels:
        out = k1.packed_stack_forward(**kw, ranks=2, level=level)
        assert all(torch.equal(a, b) for a, b in zip(out, ref)), level
    _k1_within_limits(ref, k1.packed_stack_forward_plain(**kw), mode, real,
                      limits)


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(GELU_K1_CASES))
def test_cuda_k1_gelu_heads_match_plain(card, label):
    """K1 with gelu score heads (exact, and under '-approx' the rational
    tanh) at the wrapper's R and at R = 1 against the plain version
    under the relu cases' limits, counted under the gelu variant; two
    launches give the same bits, and at N = 64 every layout level too;
    the plain version with relu heads misses the limits, and under
    '-approx' so does the one with the exact gelu, on inputs whose heads
    sit where the two forms differ (chip_smoke.py head_band)."""
    kw, mode, approx, real, limits = _k1_case(card, label)
    name = k1.variant(mode, approx, kw["pairs"].tight, gelu=True)
    assert kw["params"].act == "gelu" and "gelu" in name
    before = k1.launches[name]
    got = k1.packed_stack_forward(**kw, approx=approx)
    assert k1.launches[name] == before + 1
    again = k1.packed_stack_forward(**kw, approx=approx)
    one = k1.packed_stack_forward(**kw, approx=approx, ranks=1)
    ref = k1.packed_stack_forward_plain(**kw, approx=approx)
    n, h = kw["h0"].shape[1:]
    levels = [k1.packed_stack_forward(**kw, approx=approx, level=lv)
              for lv in (0, 1, 2) if n == 64
              and k1.smem_bytes(n, h, lv) <= k1.MAX_SMEM]
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert all(torch.equal(g, a) for lv in levels for g, a in zip(got, lv))
    for out in (got, one):
        _k1_within_limits(out, ref, mode, real, limits)
    relu = dataclasses.replace(kw["params"], act="relu", _packed={})
    with pytest.raises(AssertionError):
        _k1_within_limits(got, k1.packed_stack_forward_plain(
            **dict(kw, params=relu), approx=approx), mode, real, limits)
    if not approx:
        return
    # the exact gelu in place of the polynomial shows where the heads'
    # pre-activations sit in the band the two forms differ in
    from chip_smoke import head_band

    band = head_band(kw, True)
    got = k1.packed_stack_forward(**band, approx=True)
    ref = k1.packed_stack_forward_plain(**band, approx=True)
    saved = k1.head_activation
    k1.head_activation = lambda act, approx=False: saved(act)
    try:
        exact = k1.packed_stack_forward_plain(**band, approx=True)
    finally:
        k1.head_activation = saved
    torch.cuda.synchronize()
    _k1_within_limits(got, ref, mode, real, limits)
    with pytest.raises(AssertionError):
        _k1_within_limits(got, exact, mode, real, limits)


@pytest.mark.cuda
def test_cuda_k1_chooses_and_refuses_ranks(card):
    """Unforced, R follows ranks_for on this card's SMs; a cluster size
    the card cannot launch (16, beyond the portable 8) raises, with no
    retry at another R."""
    kw, *_ = _k1_case(card, "tight_N64")
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    k1.packed_stack_forward(**kw)
    assert k1.last_launch["ranks"] == k1.ranks_for(48, sms)
    before = dict(k1.launches)
    with pytest.raises(RuntimeError, match="ranks=16"):
        k1.packed_stack_forward(**kw, ranks=16)
    assert dict(k1.launches) == before


# K2-K5 against their plain versions, each output as a share of its own
# largest value, under chip_smoke.py's F32_KERNEL_LIMITS and
# BF16_KERNEL_LIMITS (max, median, p99): at f32 summation order only; at
# bf16 a flipped rounding of a hidden value moves the outputs that use it.
NEW_LIMITS = {torch.float32: (1e-5, 1e-6, 5e-6),
              torch.bfloat16: (1e-2, 1e-6, 3e-4)}


def _first_call(fwd, batch, name, index=0):
    """The arguments of the first call (or the call `index`) of
    models/fast_forward.<name> (a kernel wrapper) while fwd runs on
    batch."""
    from agdiff_torch.models import fast_forward as ff

    real, calls = getattr(ff, name), []

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    setattr(ff, name, record)
    try:
        fwd(batch)
    finally:
        setattr(ff, name, real)
    return calls[index]


def _small_forward(card, dtype, engine, n=32, b=8, hidden=64, **kw):
    cfg = dataclasses.replace(ModelConfig(), hidden_dim=hidden, num_convs=2,
                              num_convs_local=2, dtype=dtype)
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    mols = [m for m in load_fixture() if m.num_nodes <= n]
    batch = pad_molecules([mols[i % len(mols)] for i in range(b)], n,
                          device=card)
    return build_fast_forward(cfg, model, engine, **kw), batch


def _expected_level(wrapper, args):
    """The layout level the bf16 K2 or K3 wrapper should choose."""
    from agdiff_torch.kernels import block_packed as k2
    from agdiff_torch.kernels import fused

    e, conv1, conv2 = args[0], args[5], args[6]
    c, f1, f2 = e.shape[-1], conv1["fb"][0].shape[1], conv2["fb"][0].shape[1]
    if wrapper == "packed_block_aggregate":
        return k2.level_for(args[3].shape[1], c, f1, f2)
    return fused.block_agg_level(c, f1, f2)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper,engine,dtype,kw", [
    ("interaction_block_aggregate", "pallas", "float32", {}),
    ("interaction_block_aggregate", "pallas", "bfloat16", {}),
    ("gine_aggregate", "pallas", "float32", {}),
    ("pair_score_mlp", "pallas", "float32", dict(pack_pairs=False)),
    ("pair_score_mlp", "pallas", "bfloat16", dict(pack_pairs=False)),
    ("packed_block_aggregate", "pk", "bfloat16", {}),
    ("packed_block_aggregate", "pk-approx", "bfloat16", {}),
    # a bucket that is not a multiple of the 32-row tile
    ("interaction_block_aggregate", "pallas", "float32", dict(n=40)),
    ("gine_aggregate", "pallas", "float32", dict(n=40)),
    ("pair_score_mlp", "pallas", "bfloat16", dict(pack_pairs=False, n=40)),
    ("packed_block_aggregate", "pk", "bfloat16", dict(n=40)),
    # K3 at bf16: ragged 64-pair tiles (three node rows of 20, one of 40)
    # and fewer node rows than the card holds blocks
    ("interaction_block_aggregate", "pallas", "bfloat16", dict(n=20)),
    ("interaction_block_aggregate", "pallas", "bfloat16", dict(n=40)),
    ("interaction_block_aggregate", "pallas", "bfloat16", dict(b=1)),
    # K3 at f32 on its persistent grid: a row in two 32-pair tiles (N =
    # 40, above), ragged tiles, and fewer node rows than blocks
    ("interaction_block_aggregate", "pallas", "float32", dict(n=20)),
    ("interaction_block_aggregate", "pallas", "float32", dict(b=1)),
    # K2 at the largest N the CUDA-core form took at H = 128: level 1
    ("packed_block_aggregate", "pk", "bfloat16", dict(n=104, hidden=128))])
def test_cuda_new_kernels_match_plain(card, wrapper, engine, dtype, kw):
    """K3, K5, K4 and K2 on the inputs their engine gives them at H = 64
    (or 128), B = 8 (or 1), N = 32 (or 20, 40, 104), against the plain
    versions, each launch counted once, two launches bitwise equal; node
    outputs on real nodes, scores on the mask (zero off it). K2 and K3 at
    bf16 launch at the layout level their shape picks, K3 on no more
    blocks than its node-row groups."""
    from agdiff_torch.kernels import block_packed as k2
    from agdiff_torch.kernels import fused

    fwd, batch = _small_forward(card, dtype, engine, **kw)
    args, akw = _first_call(fwd, batch, wrapper)
    module = k2 if wrapper == "packed_block_aggregate" else fused
    counts = dict(module.launches)
    got = getattr(module, wrapper)(*args, **akw)
    assert sum(module.launches.values()) == sum(counts.values()) + 1
    ref = getattr(module, wrapper + "_plain")(*args, **akw)
    again = getattr(module, wrapper)(*args, **akw)
    torch.cuda.synchronize()
    got, ref, again = ((t,) if isinstance(t, torch.Tensor) else t
                       for t in (got, ref, again))
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    if wrapper == "interaction_block_aggregate":
        name = fused.variant("block_agg", args[0].dtype)
        b, n = args[0].shape[:2]
        launch = fused.last_launch[name]
        rows = (fused.TC_ROWS if dtype == "bfloat16"
                else fused.f32_rows(launch["level"]))
        assert 1 <= launch["grid"] <= fused.block_agg_groups(b, n, rows)[2]
    if dtype == "bfloat16" and wrapper in ("packed_block_aggregate",
                                           "interaction_block_aggregate"):
        name = (k2.variant(torch.bfloat16, akw.get("approx", False))
                if module is k2 else fused.variant("block_agg",
                                                   torch.bfloat16))
        launch = module.last_launch[name]
        assert launch["level"] == _expected_level(wrapper, args)
        if module is fused:
            b, n = args[0].shape[:2]
            assert 1 <= launch["grid"] <= fused.block_agg_groups(b, n)[2]
    limits = NEW_LIMITS[args[0].dtype]
    if wrapper == "pair_score_mlp":
        mask = args[2]
        _within_limits(got[0][mask], ref[0][mask], limits)
        assert float(got[0][~mask].abs().max()) == 0.0
    else:
        for g, r in zip(got, ref):
            _within_limits(g[batch.node_mask], r[batch.node_mask], limits)


@pytest.mark.cuda
def test_cuda_k2_f32_matches_plain(card):
    """K2's f32 variant (no engine runs it; JAX's packed_block_aggregate
    takes f32 operands) on the 'pk' inputs taken at f32."""
    from agdiff_torch.kernels import block_packed as k2

    fwd, batch = _small_forward(card, "bfloat16", "pk")
    args, kw = _first_call(fwd, batch, "packed_block_aggregate")
    args = [a.float() if isinstance(a, torch.Tensor) else a for a in args]
    before = k2.launches["packed_block:f32"]
    got = k2.packed_block_aggregate(*args, **kw)
    assert k2.launches["packed_block:f32"] == before + 1
    ref = k2.packed_block_aggregate_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        _within_limits(g[batch.node_mask], r[batch.node_mask],
                       NEW_LIMITS[torch.float32])


def _numpy_block(card, b, n, c, f1, f2, dtype, seed=0):
    """Inputs of K2 and K3 at any widths, made from a seed with numpy:
    dense (B, N, N, C) and packed (B, P, C) edge features, distance
    weights, node inputs, and two conv dicts."""
    from agdiff_torch.ops.pairs import triu_pairs

    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dt=torch.float32):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32)).to(card, dt)

    def conv(f):
        return {"fa": (t(c, f, scale=c ** -0.5), t(f, scale=0.1)),
                "fb": (t(f, f, scale=f ** -0.5), t(f, scale=0.1)),
                "beta": torch.tensor(1.3, device=card)}

    pairs = triu_pairs(n, card)
    p = pairs.num_pairs
    return dict(
        dense=(t(b, n, n, c, dt=dtype), t(b, n, n), t(b, n, n),
               t(b, n, f1), t(b, n, f2)),
        packed=(t(b, p, c, dt=dtype), t(b, p), t(b, p), t(b, n, f1, dt=dtype),
                t(b, n, f2, dt=dtype)),
        convs=(conv(f1), conv(f2)), pairs=pairs)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [3, 1])
@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k2_k3_at_widths_not_multiples_of_16(card, kernel, dtype, b):
    """C = 36, F1 = 20, F2 = 12 (multiples of 4, not of 16), B = 3 and 1:
    the tensor-core tile zero-pads them; K3 at f32 takes F1 + F2 = 32
    columns in units of 6 (zero-padded to 36 in its staged fa); K2 at f32
    takes them as it did."""
    from agdiff_torch.kernels import block_packed as k2
    from agdiff_torch.kernels import fused

    x = _numpy_block(card, b, 20, 36, 20, 12, dtype)
    c1, c2 = x["convs"]
    if kernel == "K3":
        args = (*x["dense"], c1, c2)
        run, plain = (fused.interaction_block_aggregate,
                      fused.interaction_block_aggregate_plain)
    else:
        args = (*x["packed"], c1, c2, x["pairs"])
        run, plain = (k2.packed_block_aggregate,
                      k2.packed_block_aggregate_plain)
    got, again, ref = run(*args), run(*args), plain(*args)
    torch.cuda.synchronize()
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a)
        _within_limits(g, r, NEW_LIMITS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,approx", [("K2", False), ("K2", True),
                                          ("K3", False), ("K3-f32", False)])
def test_cuda_k2_k3_layout_levels_give_the_same_bits(card, kernel, approx):
    """Level 1 (weights read from L2) against level 0 (weights staged in
    shared memory) at bf16, and K3's f32 levels 0 (fa and fb1 staged), 1
    (fa), 2 (neither) and 3 (32-pair tiles), at the main widths (C = F1 =
    128, F2 = 64) and at widths that are not multiples of 16."""
    from agdiff_torch.kernels import block_packed as k2
    from agdiff_torch.kernels import fused

    for n, (c, f1, f2) in ((32, (128, 128, 64)), (20, (36, 20, 12))):
        dtype = torch.float32 if kernel == "K3-f32" else torch.bfloat16
        x = _numpy_block(card, 4, n, c, f1, f2, dtype, seed=n)
        c1, c2 = x["convs"]
        if kernel == "K3-f32":
            outs = [fused.block_agg_launch(*x["dense"], c1, c2, level=lv)
                    for lv in (0, 1, 2, 3)]
            assert fused.last_launch["block_agg:f32"]["level"] == 3
            torch.cuda.synchronize()
            for other in outs[1:]:
                assert all(torch.equal(a, b) for a, b in zip(outs[0], other))
            continue
        elif kernel == "K3":
            outs = [fused.block_agg_launch(*x["dense"], c1, c2, level=lv)
                    for lv in (0, 1)]
            assert fused.last_launch["block_agg:bf16"]["level"] == 1
        else:
            outs = [k2.packed_block_launch(*x["packed"], c1, c2, x["pairs"],
                                           approx=approx, level=lv)
                    for lv in (0, 1)]
            assert k2.last_launch[k2.variant(torch.bfloat16,
                                             approx)]["level"] == 1
        torch.cuda.synchronize()
        for a, b in zip(*outs):
            assert torch.equal(a, b)


def _k4_inputs(card, dtype, head, n, b, variant):
    """K4's arguments on a 'pallas' forward with pack_pairs=False at H =
    64 (128 at N = 128): the global head's (head 0) or the local head's (1), or the global
    head's h with a random asymmetric mask and random e ('asymmetric'), a
    mask of every real-atom pair ('all_real'), or graph 1's mask emptied
    ('empty_graph')."""
    fwd, batch = _small_forward(card, dtype, "pallas", n=n, b=b,
                                hidden=128 if n == 128 else 64,
                                pack_pairs=False)
    h, e, mask, *w = _first_call(fwd, batch, "pair_score_mlp", head)[0]
    rng = np.random.default_rng(n + b)
    if variant == "asymmetric":
        mask = torch.from_numpy(rng.random(tuple(mask.shape)) < 0.3).to(card)
        e = torch.from_numpy(rng.normal(0, 0.5, tuple(e.shape)).astype(
            np.float32)).to(card, e.dtype)
        assert not torch.equal(mask, mask.transpose(1, 2))
    elif variant == "all_real":
        real = batch.node_mask
        mask = (real[:, :, None] & real[:, None, :]
                & ~torch.eye(n, dtype=torch.bool, device=card))
    elif variant == "empty_graph":
        mask = mask.clone()
        mask[1] = False
    return (h, e, mask, *w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,head,n,b,variant", [
    ("float32", 0, 32, 8, ""), ("bfloat16", 0, 32, 8, ""),
    ("float32", 1, 32, 8, ""), ("bfloat16", 1, 32, 8, ""),
    ("float32", 0, 20, 8, ""), ("bfloat16", 0, 20, 8, ""),
    ("float32", 0, 40, 8, ""), ("bfloat16", 0, 40, 8, ""),
    ("float32", 0, 64, 4, ""), ("bfloat16", 1, 64, 4, ""),
    ("float32", 0, 32, 1, ""), ("bfloat16", 0, 32, 1, ""),
    ("float32", 0, 32, 8, "asymmetric"), ("bfloat16", 0, 32, 8, "asymmetric"),
    ("float32", 0, 32, 8, "empty_graph"),
    ("bfloat16", 0, 32, 8, "empty_graph"),
    ("float32", 0, 32, 8, "all_real"), ("bfloat16", 0, 32, 8, "all_real"),
    # f32 at N = 128, H = 128: the lists go to the scratch at level 0
    ("float32", 0, 128, 2, "")])
def test_cuda_k4_masked_pairs_match_plain(card, dtype, head, n, b, variant):
    """K4 over each graph's masked pairs against the plain version on the
    mask (within NEW_LIMITS) and exactly 0 off it, one launch counted per
    call, two launches bitwise equal, and every layout level that fits and
    every CTAs-per-graph R (1, 2, 3) giving the same bits: both heads,
    N = 20, 40, 64, 128, B = 1, an asymmetric mask and e, every real pair,
    a graph with no masked pair."""
    from agdiff_torch.kernels import fused

    args = _k4_inputs(card, dtype, head, n, b, variant)
    h, mask = args[0], args[2]
    name = fused.variant("pair_score", h.dtype)
    before = fused.launches[name]
    got = fused.pair_score_mlp(*args)
    assert fused.launches[name] == before + 1
    launch = dict(fused.last_launch[name])
    assert launch["grid"] == b * launch["ranks"]
    c, h1, h2 = h.shape[-1], args[3].shape[1], args[5].shape[1]
    level, _, in_smem = fused.pair_score_layout(n, c, h1, h2, h.dtype)
    assert launch["level"] == level
    assert launch["lists"] == ("smem" if in_smem else "scratch")
    if n == 128:
        assert launch["lists"] == "scratch"
    again = fused.pair_score_mlp(*args)
    ref = fused.pair_score_mlp_plain(*args)
    levels = [lv for lv in ((0, 1) if dtype == "bfloat16" else (0, 1, 2))
              if fused.pair_score_smem(c, h1, h2, h.dtype, lv)
              + fused.pair_score_h_bytes(n, c, h.dtype) <= fused.MAX_SMEM]
    others = [fused.pair_score_launch(*args, level=lv) for lv in levels]
    others += [fused.pair_score_launch(*args, ranks=r) for r in (1, 2, 3)]
    torch.cuda.synchronize()
    assert len(levels) >= 2
    assert torch.equal(got, again)
    assert all(torch.equal(got, o) for o in others)
    if mask.any():
        _within_limits(got[mask], ref[mask], NEW_LIMITS[h.dtype])
    assert not bool(got[~mask].any())
    if variant == "empty_graph":
        assert not bool(got[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h1,h2", [(36, 20, 12), (160, 160, 80)])
def test_cuda_k4_at_widths_off_the_main_path(card, dtype, c, h1, h2):
    """K4 on numpy-made inputs at C = 36, H1 = 20, H2 = 12 (not multiples
    of 16 or 8: zero-padded tiles, 8-byte loads of e) and at C = 160 (the
    f32 tile's operands beyond the four a thread holds in registers),
    N = 20, B = 3, a random asymmetric mask: within NEW_LIMITS on the mask,
    0 off it, every level and R the same bits."""
    from agdiff_torch.kernels import fused

    rng = np.random.default_rng(c)
    b, n = 3, 20

    def t(*shape, scale=1.0, dt=torch.float32):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32)).to(card, dt)

    args = (t(b, n, c, dt=dtype), t(b, n, n, c, scale=0.5, dt=dtype),
            torch.from_numpy(rng.random((b, n, n)) < 0.4).to(card),
            t(2 * c, h1, scale=(2 * c) ** -0.5, dt=dtype), t(h1, scale=0.1),
            t(h1, h2, scale=h1 ** -0.5, dt=dtype), t(h2, scale=0.1),
            t(h2, 1, scale=h2 ** -0.5, dt=dtype), t(1, scale=0.1))
    mask = args[2]
    got = fused.pair_score_mlp(*args)
    ref = fused.pair_score_mlp_plain(*args)
    levels = [lv for lv in ((0, 1) if dtype == torch.bfloat16 else (0, 1, 2))
              if fused.pair_score_smem(c, h1, h2, dtype, lv)
              + fused.pair_score_h_bytes(n, c, dtype) <= fused.MAX_SMEM]
    others = [fused.pair_score_launch(*args, level=lv) for lv in levels]
    others += [fused.pair_score_launch(*args, ranks=r) for r in (1, 3)]
    torch.cuda.synchronize()
    assert all(torch.equal(got, o) for o in others)
    _within_limits(got[mask], ref[mask], NEW_LIMITS[dtype])
    assert not bool(got[~mask].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,head", [("float32", 0), ("bfloat16", 0),
                                        ("float32", 1), ("bfloat16", 1)])
def test_cuda_k4_gelu_matches_plain(card, dtype, head):
    """K4 with gelu activations on each head's inputs at N = 32, B = 8:
    within NEW_LIMITS of the plain twin with gelu on the mask, exactly 0
    off it, counted under 'pair_score_gelu', every layout level and R
    the same bits; relu's result misses the limits."""
    from agdiff_torch.kernels import fused

    args = _k4_inputs(card, dtype, head, 32, 8, "")
    h, mask = args[0], args[2]
    name = fused.variant("pair_score_gelu", h.dtype)
    before = fused.launches[name]
    got = fused.pair_score_mlp(*args, activation="gelu")
    assert fused.launches[name] == before + 1
    ref = fused.pair_score_mlp_plain(*args, activation="gelu")
    relu = fused.pair_score_mlp_plain(*args)
    c, h1, h2 = h.shape[-1], args[3].shape[1], args[5].shape[1]
    levels = [lv for lv in ((0, 1) if dtype == "bfloat16" else (0, 1, 2))
              if fused.pair_score_smem(c, h1, h2, h.dtype, lv)
              + fused.pair_score_h_bytes(32, c, h.dtype) <= fused.MAX_SMEM]
    others = [fused.pair_score_launch(*args, activation="gelu", level=lv)
              for lv in levels]
    others += [fused.pair_score_launch(*args, activation="gelu", ranks=r)
               for r in (1, 2, 3)]
    torch.cuda.synchronize()
    assert all(torch.equal(got, o) for o in others)
    _within_limits(got[mask], ref[mask], NEW_LIMITS[h.dtype])
    assert not bool(got[~mask].any())
    with pytest.raises(AssertionError):
        _within_limits(got[mask], relu[mask], NEW_LIMITS[h.dtype])


@pytest.mark.cuda
def test_cuda_new_wrappers_reject_what_the_kernels_do_not_take(card):
    """K5 takes f32 only; K2 the triu set only, not a tight list; K4 relu
    or gelu heads (a gelu call gives the plain twin's gelu result, tanh
    raises); every input on the card."""
    from agdiff_torch.kernels import block_packed as k2
    from agdiff_torch.kernels import fused
    from agdiff_torch.ops.pairs import prepare_pairs_shared

    fwd, batch = _small_forward(card, "float32", "pallas")
    x, e, mask = _first_call(fwd, batch, "gine_aggregate")[0]
    with pytest.raises(TypeError):
        fused.gine_aggregate(x.bfloat16(), e.bfloat16(), mask)
    with pytest.raises(ValueError):
        fused.gine_aggregate(x, e, mask.cpu())
    args = _first_call(fwd, batch, "interaction_block_aggregate")[0]
    with pytest.raises(ValueError):
        fused.interaction_block_aggregate(args[0], args[1].cpu(), *args[2:])
    pk, batch = _small_forward(card, "bfloat16", "pk")
    args, kw = _first_call(pk, batch, "packed_block_aggregate")
    tight = prepare_pairs_shared(batch.node_mask, args[-1].num_pairs)
    with pytest.raises(ValueError, match="triu"):
        k2.packed_block_aggregate(*args[:-1], tight, **kw)
    dense, batch = _small_forward(card, "float32", "pallas",
                                  pack_pairs=False)
    args, _ = _first_call(dense, batch, "pair_score_mlp")
    got = fused.pair_score_mlp(*args, activation="gelu")
    ref = fused.pair_score_mlp_plain(*args, activation="gelu")
    torch.cuda.synchronize()
    mask = args[2]
    _within_limits(got[mask], ref[mask], NEW_LIMITS[torch.float32])
    assert not bool(got[~mask].any())
    with pytest.raises(ValueError, match="relu or gelu"):
        fused.pair_score_mlp(*args, activation="tanh")


# K6 against its plain version, each plane on its mask (em / lm) as a
# share of its own largest value there, under chip_smoke.py's MONO_LIMITS
# (max, median, p99; global plane, local plane); off the masks both are
# exactly 0. Positions spread 6 A, so that pairs straddle the cutoff. At
# Drugs size a flipped bf16 rounding of a GIN message spreads through its
# graph (hl ~ 300), hence the local plane's wide limits there.
MONO = {torch.bfloat16: ((3e-2, 1e-5, 5e-3), (5e-2, 1e-5, 2e-2)),
        torch.float32: ((1e-5, 1e-6, 5e-6), (1e-5, 1e-6, 5e-6))}
MONO_DRUGS = ((3e-2, 1e-4, 5e-3), (0.25, 1e-2, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,h,n,b,variant", [
    ("bfloat16", 64, 32, 8, ""), ("float32", 64, 32, 8, ""),
    ("bfloat16", 128, 32, 16, ""), ("float32", 128, 32, 16, ""),
    ("bfloat16", 128, 64, 4, ""),
    # the working list: the whole triangle, the bond graph, one graph
    # with no working pair, and ragged tiles (N = 20, 40)
    ("bfloat16", 64, 32, 8, "em_all_ones"),
    ("float32", 64, 32, 8, "em_all_ones"),
    ("bfloat16", 64, 32, 8, "em_is_lm"), ("float32", 64, 32, 8, "em_is_lm"),
    ("bfloat16", 64, 32, 8, "empty_graph"),
    ("float32", 64, 32, 8, "empty_graph"),
    ("bfloat16", 64, 20, 8, ""), ("bfloat16", 128, 40, 8, ""),
    ("float32", 64, 40, 8, "")])
def test_cuda_mono_matches_plain(card, dtype, h, n, b, variant):
    """K6 at a small width and at full width (N = 64: node temporaries in
    global memory, the cosine envelope), one launch counted per call, two
    launches bitwise equal, every layout level that fits giving the same
    bits; with em all ones (the working list is the triangle), em = lm,
    one graph's masks zeroed (an empty list: both planes 0) and N = 20,
    40."""
    _mono_case(card, dtype, h, n, b, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,b", [("bfloat16", 32, 16),
                                       ("float32", 32, 16),
                                       ("bfloat16", 64, 4)])
def test_cuda_mono_gelu_matches_plain(card, dtype, n, b):
    """K6 with gelu score heads at full width (QM9 bf16 and f32, Drugs
    bf16), as test_cuda_mono_matches_plain, counted under 'mono_gelu'."""
    _mono_case(card, dtype, 128, n, b, "", act="gelu")


def _mono_case(card, dtype, h, n, b, variant, act="relu"):
    from agdiff_torch.kernels import monolithic as k6
    from agdiff_torch.models.mono_forward import build_monolithic_forward

    cfg = dataclasses.replace(ModelConfig(), hidden_dim=h, dtype=dtype,
                              smooth_conv=n == 64,
                              num_convs=2 if h == 64 else 6,
                              num_convs_local=2 if h == 64 else 4,
                              mlp_act=act)
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    fwd = build_monolithic_forward(cfg, model)
    mols = [m for m in (load_fixture() if n <= 40 else
                        load_fixture("drugs_synthetic")[:1])
            if m.num_nodes <= n]
    batch = pad_molecules([mols[i % len(mols)] for i in range(b)], n,
                          device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    batch = batch.replace(pos=6.0 * torch.randn(
        batch.pos.shape, generator=gen, device=card)
        * batch.node_mask[..., None])
    kw, _ = fwd.kernel_inputs(batch)
    if variant == "em_all_ones":
        kw["em"] = torch.ones_like(kw["em"])
    elif variant == "em_is_lm":
        kw["em"] = kw["lm"].clone()
    elif variant == "empty_graph":
        kw["em"], kw["lm"] = kw["em"].clone(), kw["lm"].clone()
        kw["em"][1] = 0.0
        kw["lm"][1] = 0.0
    name = k6.variant(fwd.compute_dtype, act)
    before = k6.launches[name]
    got = k6.mono_forward(**kw)
    assert k6.launches[name] == before + 1
    again = k6.mono_forward(**kw)
    ref = k6.mono_forward_plain(**kw)
    itemsize = 2 if fwd.compute_dtype == torch.bfloat16 else 4
    levels = [k6.mono_forward(**kw, level=lv) for lv in (0, 1, 2)
              if k6.smem_bytes(n, h, itemsize, lv) <= k6.MAX_SMEM]
    torch.cuda.synchronize()
    assert len(levels) >= 2
    limits = MONO_DRUGS if n == 64 else MONO[fwd.compute_dtype]
    for k, (g, a, r, mask, lim) in enumerate(zip(
            got, again, ref, (kw["em"] > 0, kw["lm"] > 0), limits)):
        assert torch.equal(g, a)
        assert all(torch.equal(g, lv[k]) for lv in levels)
        _within_limits(g[mask], r[mask], lim)
        assert not bool(g[~mask].any())
        if variant == "empty_graph":
            assert not bool(g[1].any())


@pytest.mark.cuda
def test_cuda_mono_wrapper_rejects_what_the_kernel_does_not_take(card):
    """A tight pair list, an int64 type plane, a tensor on the CPU."""
    from agdiff_torch.kernels import monolithic as k6
    from agdiff_torch.models.mono_forward import build_monolithic_forward
    from agdiff_torch.ops.pairs import prepare_pairs_shared

    cfg = dataclasses.replace(ModelConfig(), hidden_dim=64, num_convs=1,
                              num_convs_local=1, dtype="bfloat16")
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    batch = pad_molecules(load_fixture()[:2], 32, device=card)
    kw, _ = build_monolithic_forward(cfg, model).kernel_inputs(batch)
    tight = prepare_pairs_shared(batch.node_mask, kw["pairs"].num_pairs)
    with pytest.raises(ValueError, match="triu"):
        k6.mono_forward(**dict(kw, pairs=tight))
    with pytest.raises(TypeError):
        k6.mono_forward(**dict(kw, tp=kw["tp"].long()))
    with pytest.raises(ValueError):
        k6.mono_forward(**dict(kw, lm=kw["lm"].cpu()))


# ---- the ladder as CUDA graphs (sampling/graphed.py) -------------------------

def _samplers(fwd, config, capacity=None):
    """A graphed sampler (the default on a card) and an eager one."""
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import build_fast_sampler

    diffusion = make_diffusion(ModelConfig())
    return (build_fast_sampler(fwd, diffusion, config,
                               pair_capacity=capacity),
            build_fast_sampler(fwd, diffusion, config,
                               pair_capacity=capacity, graph=False))


def _run(sampler, batch, seed=0):
    """A ladder from a seeded start with a seeded generator."""
    dev = batch.pos.device
    pos0 = torch.randn(batch.pos.shape, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    return sampler(batch, pos0, generator=torch.Generator(
        device=dev).manual_seed(seed + 1))


def _same_bits(a, b):
    assert torch.equal(a.pos, b.pos)
    assert torch.equal(a.nan_flags, b.nan_flags)
    assert torch.isfinite(a.pos).all()


@pytest.mark.cuda
def test_cuda_graphed_ladder_gives_the_eager_bits(card):
    """K1 over the triu set: a 25-step ladder (a 20-step block and a
    5-step one) graphed and eager give the same bits; a second run
    replays the same graphs; each replay counts the launches its graph
    captured, and the wrappers' counters move at capture only."""
    from agdiff_torch.sampling import graphed as gr
    from agdiff_torch.sampling.langevin import SamplerConfig

    fwd, batch = _small_forward(card, "bfloat16", "pksf")
    graphed, eager = _samplers(fwd, SamplerConfig(n_steps=25, w_global=0.3))
    name = "stack_packed/" + k1.variant("full", False, False)
    want = _run(eager, batch)
    _same_bits(_run(graphed, batch), want)
    (graphs,) = graphed.ladders.values()
    assert sorted(graphs.captured) == [("ladder", 5), ("ladder", 20)]
    assert graphs.captured[("ladder", 20)][0][name] == 20
    assert graphs.captured[("ladder", 5)][1] == 5
    launched, replayed, calls = (gr.kernel_counts()[name], gr.replayed[name],
                                 fwd.calls)
    _same_bits(_run(graphed, batch), want)
    assert len(graphed.ladders) == 1
    assert gr.kernel_counts()[name] == launched
    assert gr.replayed[name] == replayed + 25
    assert fwd.calls == calls + 25


@pytest.mark.cuda
def test_cuda_node_counter_counts_plain_ops(card):
    """A captured block of k in-place elementwise ops adds k graph nodes,
    read from libcuda while the stream captures; outside a capture
    the count is None."""
    from agdiff_torch.sampling.graphed import capture_nodes

    stream = torch.cuda.Stream()
    x = torch.ones(1024, device=card)
    torch.cuda.synchronize()
    assert capture_nodes(stream) is None
    for k in (1, 7):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            start = capture_nodes(stream)
            for _ in range(k):
                x.add_(1.0)
            end = capture_nodes(stream)
        assert (start, end - start) == (0, k)


@pytest.mark.cuda
def test_cuda_ladder_node_counts(card):
    """K1 over the triu set, a 25-step ladder (a 20-step block and a
    5-step one): each block's forward holds some of its nodes and not
    all, a 20-step block 4 times the 5-step one's (the step's nodes
    repeat); a run replays each block once and adds its nodes and steps
    to the counters."""
    from agdiff_torch.sampling.langevin import SamplerConfig
    from agdiff_torch.utils import profiling

    fwd, batch = _small_forward(card, "bfloat16", "pksf")
    graphed, _ = _samplers(fwd, SamplerConfig(n_steps=25, w_global=0.3))
    _run(graphed, batch)
    (graphs,) = graphed.ladders.values()
    total, forward = graphs.nodes[("ladder", 20)]
    assert 0 < forward < total
    assert graphs.nodes[("ladder", 5)] == (total // 4, forward // 4)
    before = profiling.counters()
    _run(graphed, batch)
    after = profiling.counters()
    moved = {k: after[k] - before.get(k, 0) for k in after}
    assert moved == {"ladder.replayed_nodes": total + total // 4,
                     "forward.replayed_nodes": forward + forward // 4,
                     "ladder.replayed_steps": 25}


@pytest.mark.cuda
def test_cuda_block_nodes_are_the_profiled_device_operations(card):
    """At the benchmark cell's model and chunk (QM9 width, 6 + 4 convs,
    bf16 'pksf', B = 128 at bucket 32, a kept 20-step block): the graph
    nodes counted at capture equal the device operations torch.profiler
    sees the block's one graph launch run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import (
        SamplerConfig,
        build_fast_sampler,
    )

    cfg = dataclasses.replace(ModelConfig(), dtype="bfloat16",
                              packed_pairs=True)
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    mols = load_fixture()
    batch = pad_molecules([mols[i % len(mols)] for i in range(128)], 32,
                          device=card)
    sampler = build_fast_sampler(
        build_fast_forward(cfg, model, "pksf"), make_diffusion(cfg),
        SamplerConfig(n_steps=20, w_global=0.3, clip_local=20.0,
                      traj_stride=20))
    _run(sampler, batch)
    (graphs,) = sampler.ladders.values()
    total, forward = graphs.nodes[("ladder", 20)]
    graphs.ladder.counter.zero_()   # the block again from the first step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graphs.replay("ladder", 20)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    launch = {e.correlation_id() for e in events
              if e.name() == "cudaGraphLaunch"}
    ops = [e for e in events if e.device_type() == DeviceType.CUDA]
    replayed = [e for e in ops if e.correlation_id() in launch]
    print(f"20-step pksf block at B=128 N=32: {total} graph nodes "
          f"({forward} in the forward); in one replay {len(replayed)} "
          f"device operations of the graph's launch, {len(ops)} in all")
    assert len(launch) == 1 and len(replayed) == total


@pytest.mark.cuda
def test_cuda_graphs_of_two_tight_molecules_in_one_bucket(card):
    """Two Drugs molecules of 50 and 56 atoms in bucket 64 at one
    capacity: their tight lists differ (V = 1225, 1540), so each has its
    graphs, and runs of the first, the second and the first again each
    give their eager bits; a new list's capture frees the last list's
    graphs (one ladder is left), and graphs run with the other molecule's
    list raise."""
    from agdiff_torch.sampling.langevin import SamplerConfig

    cfg = dataclasses.replace(ModelConfig(), hidden_dim=64, num_convs=2,
                              num_convs_local=2, dtype="bfloat16")
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    fwd = build_tight_forward(cfg, model, "tight-pksf")
    mols = load_fixture("drugs_synthetic")[:2]
    cap = pair_capacity_for(max(m.num_nodes for m in mols), 256)
    graphed, eager = _samplers(fwd, SamplerConfig(n_steps=20, w_global=0.3),
                               capacity=cap)
    batches = [pad_molecules([m] * 8, 64, device=card) for m in mols]
    seen = []
    for batch in batches + batches[:1]:
        _same_bits(_run(graphed, batch), _run(eager, batch))
        (graphs,) = graphed.ladders.values()
        seen.append(graphs)
    assert [g.key[3] for g in seen] == [1225, 1540, 1225]
    assert len({id(g) for g in seen}) == 3
    with pytest.raises(ValueError, match="pair list"):
        seen[0].run(batches[1], graphed.pairs(batches[1]),
                    torch.zeros_like(batches[1].pos))


@pytest.mark.cuda
def test_cuda_runner_frees_each_molecules_graphs(card):
    """The runner over four Drugs-size molecules in bucket 64 at B = 48
    and width 128 (50 and 51 atoms at one pair capacity, then 53 and 56
    atoms at two others): each molecule's tight list frees the last
    molecule's graphs, so every sampler keeps at most one ladder, and the
    device memory reserved after the last molecule exceeds that after the
    first by less than one ladder's pool (keeping them all would add a
    pool a molecule)."""
    from agdiff_torch.data.synthetic import synthetic_dataset
    from agdiff_torch.eval.generate import GenerationRunner
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import SamplerConfig

    cfg = dataclasses.replace(ModelConfig(), hidden_dim=128, num_convs=2,
                              num_convs_local=2, dtype="bfloat16")
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    synth = synthetic_dataset(4, seed=1, min_heavy=20, max_heavy=24)
    mols = [load_fixture("drugs_synthetic")[0], synth[0], synth[1],
            synth[3]]
    assert [m.num_nodes for m in mols] == [50, 51, 53, 56]
    runner = GenerationRunner(model, cfg, make_diffusion(cfg),
                              SamplerConfig(n_steps=5, w_global=0.3),
                              buckets=(64,), chunk_size=48, device=card)
    reserved, pools = [], []
    for mol in mols:
        runner.run([mol], seed=0, num_confs=48)
        torch.cuda.synchronize(card)
        samplers = runner._samplers.values()
        assert len(samplers) <= 2   # the ladder and its clip_local retry
        assert all(len(s.ladders) <= 1 for s in samplers)
        reserved.append(torch.cuda.memory_reserved(card))
        pools.append(sum(g.pool_bytes for s in samplers
                         for g in s.ladders.values()))
    assert min(pools) > 0
    assert reserved[-1] - reserved[0] < max(pools), (reserved, pools)


@pytest.mark.cuda
def test_cuda_graphs_survive_k6_scratch_growth(card):
    """K6's scratch grows by replacing the cached tensor: a graph captured
    on the small scratch holds it, so after a larger batch's capture has
    grown it, both graphs still give their eager bits."""
    from agdiff_torch.models.mono_forward import build_monolithic_forward
    from agdiff_torch.sampling.langevin import SamplerConfig

    cfg = dataclasses.replace(ModelConfig(), hidden_dim=64, num_convs=2,
                              num_convs_local=2, dtype="bfloat16")
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    fwd = build_monolithic_forward(cfg, model)
    graphed, eager = _samplers(fwd, SamplerConfig(n_steps=10, w_global=0.3))
    mols = load_fixture()
    small = pad_molecules(mols[:2] * 2, 32, device=card)
    large = pad_molecules(mols * 8, 32, device=card)

    def scratch():
        return [v for (_, n), v in fwd.params._scratch.items()
                if n == "e32"]

    _same_bits(_run(graphed, small), _run(eager, small))
    before = scratch()
    _same_bits(_run(graphed, large), _run(eager, large))
    assert len(before) == 1 and scratch()[0] is not before[0]
    _same_bits(_run(graphed, small), _run(eager, small))
    assert len(graphed.ladders) == 2


@pytest.mark.cuda
def test_cuda_runner_warm_and_module_path(card):
    """GenerationRunner.warm captures each ladder once; after it the runner
    gives the eager runner's samples. The dense module path graphs too."""
    from agdiff_torch.eval.generate import GenerationRunner
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import SamplerConfig, build_sampler

    cfg = dataclasses.replace(ModelConfig(), hidden_dim=64, num_convs=2,
                              num_convs_local=2, dtype="bfloat16")
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    mols = load_fixture()[:2]
    out = []
    for graph in (True, False):
        runner = GenerationRunner(model, cfg, make_diffusion(cfg),
                                  SamplerConfig(n_steps=12, w_global=0.3),
                                  buckets=(32,), chunk_size=8, device=card,
                                  graph=graph)
        warmed = runner.warm(mols[0], retry=True)
        assert warmed == ([(32, 8, False), (32, 8, True)] if graph
                          else [])
        assert runner.warm(mols[0]) == []
        out.append(runner.run(mols, seed=3, num_confs=8))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.meta["pos_gen"], b.meta["pos_gen"])
    batch = pad_molecules(mols * 2, 32, device=card)
    config = SamplerConfig(n_steps=5, w_global=0.3)
    pos0 = torch.randn(batch.pos.shape, device=card)
    runs = [build_sampler(model, make_diffusion(cfg), config, graph=g)(
        batch, pos0, generator=torch.Generator(device=card).manual_seed(2))
        for g in (True, False)]
    _same_bits(runs[0], runs[1])


@pytest.mark.cuda
def test_cuda_capture_failure_raises(card):
    """A forward that waits on the host cannot be captured: the sampler
    raises, and does not fall back to the eager loop."""
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import (
        SamplerConfig,
        build_fast_sampler,
    )

    fwd, batch = _small_forward(card, "bfloat16", "pksf")

    def syncing(b, **kw):
        float(b.pos.sum())
        return fwd(b, **kw)

    syncing.prepare = fwd.prepare
    sampler = build_fast_sampler(syncing, make_diffusion(ModelConfig()),
                                 SamplerConfig(n_steps=3))
    with pytest.raises(RuntimeError):
        sampler(batch, torch.randn(batch.pos.shape, device=card))
    assert sampler.ladders == {}


# ---- NaN through the kernels (the sampler's guard) ---------------------------
# A NaN edge feature (a non-finite distance) must reach the kernel's output
# as it reaches the plain version's, which is the reference's: a relu, max
# or clamp that drops it hides a diverging graph from the sampler's guard.

def _same_nan_pattern(got, ref, limits):
    """The non-finite elements where the plain version has them, the
    finite ones within `limits` of it."""
    bad = ~torch.isfinite(ref)
    assert torch.equal(~torch.isfinite(got), bad)
    assert bool(bad.any()) and bool((~bad).any())
    _within_limits(got[~bad], ref[~bad], limits)


def _real_pair_slot(pairs, node_mask, g):
    """A slot of the list whose pair joins two real atoms of graph g."""
    iu, ju = pairs.iu, pairs.ju
    if not pairs.shared:
        iu, ju = iu[g], ju[g]
    real = node_mask[g]
    ok = real[iu] & real[ju] & (iu != ju)
    if pairs.tight:
        ok[pairs.num_valid:] = False
    return int(torch.nonzero(ok)[3])


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["triu_B48_N64", "tight_N64", "schnet_N64",
                                   "gin_N64", "full_approx_N64"])
def test_cuda_k1_keeps_nan(card, label):
    """K1 with one real pair's edge features NaN (both planes) in graph
    1: NaN where the plain version has it (every node and plane of that
    graph), the rest within the case's limits."""
    kw, mode, approx, real, limits = _k1_case(card, label)
    slot = _real_pair_slot(kw["pairs"], real, 1)
    for key in ("e_packed", "e_packed_local"):
        kw[key] = kw[key].clone()
        kw[key][1, slot] = float("nan")
    got = k1.packed_stack_forward(**kw, mode=mode, approx=approx)
    ref = k1.packed_stack_forward_plain(**kw, mode=mode, approx=approx)
    torch.cuda.synchronize()
    names = {"full": ("global", "local"), "gin": ("h", "hl"),
             "schnet": ("h",)}[mode]
    for name, g, r in zip(names, _k1_outputs(got, mode),
                          _k1_outputs(ref, mode)):
        if mode != "full":
            g, r = g[real], r[real]
        lim = (BF16_MAX, BF16_MEDIAN, BF16_P99) if limits is None \
            else limits[name]
        _same_nan_pattern(g, r, lim)
        assert not bool(torch.isfinite(r if mode != "full" else r[1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper,engine,dtype,kw", [
    ("interaction_block_aggregate", "pallas", "float32", {}),
    ("interaction_block_aggregate", "pallas", "bfloat16", {}),
    ("gine_aggregate", "pallas", "float32", {}),
    ("pair_score_mlp", "pallas", "float32", dict(pack_pairs=False)),
    ("pair_score_mlp", "pallas", "bfloat16", dict(pack_pairs=False)),
    ("packed_block_aggregate", "pk", "bfloat16", {}),
    ("packed_block_aggregate", "pk-approx", "bfloat16", {})])
def test_cuda_new_kernels_keep_nan(card, wrapper, engine, dtype, kw):
    """K3, K5, K4 and K2 with one real pair's edge features NaN in graph
    1, and for K4 and K5 also one pair off the mask: the plain version's
    NaN pattern (K4 writes 0 off its mask, as the reference's where does;
    K5's reference applies the mask after the relu, so a NaN off the mask
    reaches the sum), the rest within the kernel's limits."""
    from agdiff_torch.kernels import block_packed as k2
    from agdiff_torch.kernels import fused

    fwd, batch = _small_forward(card, dtype, engine, **kw)
    args, akw = _first_call(fwd, batch, wrapper)
    args = list(args)
    masked = wrapper in ("pair_score_mlp", "gine_aggregate")
    at = 1 if masked else 0
    e = args[at].clone()
    real = batch.node_mask[1]
    if wrapper == "packed_block_aggregate":
        e[1, _real_pair_slot(args[7], batch.node_mask, 1)] = float("nan")
    elif masked:   # one pair on the mask, one off it, both in real rows
        mask = args[2]
        on = torch.nonzero(mask[1] & real[:, None] & real[None, :])[0]
        off = torch.nonzero(~mask[1] & real[:, None])[0]
        e[1, on[0], on[1]] = e[1, off[0], off[1]] = float("nan")
    else:
        e[1, 0, 1] = e[1, 1, 0] = float("nan")
    args[at] = e
    module = k2 if wrapper == "packed_block_aggregate" else fused
    got = getattr(module, wrapper)(*args, **akw)
    ref = getattr(module, wrapper + "_plain")(*args, **akw)
    torch.cuda.synchronize()
    got, ref = ((t,) if isinstance(t, torch.Tensor) else t
                for t in (got, ref))
    limits = NEW_LIMITS[args[0].dtype]
    for g, r in zip(got, ref):
        if wrapper == "pair_score_mlp":
            assert float(g[1, off[0], off[1]]) == 0.0
            assert bool(torch.isnan(g[1, on[0], on[1]]))
        elif wrapper == "gine_aggregate":
            assert bool(torch.isnan(g[1, off[0]]).all())
        node = batch.node_mask if wrapper != "pair_score_mlp" else \
            torch.ones_like(g, dtype=torch.bool)
        _same_nan_pattern(g[node], r[node], limits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n", [("bfloat16", 32), ("float32", 32),
                                     ("bfloat16", 64)])
def test_cuda_mono_keeps_nan(card, dtype, n):
    """K6 with one bonded pair's distance NaN in graph 1 (positions spread
    6 A, as test_cuda_mono_matches_plain's): that graph's planes carry
    NaN, as the plain version's do, every other graph keeps the bits it
    has without the NaN, and cells off the working graph stay 0 (a cell
    on it but off a plane's mask is that plane's score times 0, NaN for a
    NaN score, as in the plain version and the reference). K6 walks only
    the working graph's pairs, so NaN x 0 terms of the pairs off it,
    which the plain version (and the reference) sum, do not reach it:
    the pattern inside graph 1 may be narrower, the graph is flagged all
    the same."""
    from agdiff_torch.kernels import monolithic as k6
    from agdiff_torch.models.mono_forward import build_monolithic_forward

    h = 128 if n == 64 else 64
    cfg = dataclasses.replace(ModelConfig(), hidden_dim=h, dtype=dtype,
                              smooth_conv=n == 64,
                              num_convs=2 if h == 64 else 6,
                              num_convs_local=2 if h == 64 else 4)
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    fwd = build_monolithic_forward(cfg, model)
    mols = [m for m in (load_fixture() if n <= 40 else
                        load_fixture("drugs_synthetic")[:1])
            if m.num_nodes <= n]
    batch = pad_molecules([mols[i % len(mols)] for i in range(4)], n,
                          device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    batch = batch.replace(pos=6.0 * torch.randn(
        batch.pos.shape, generator=gen, device=card)
        * batch.node_mask[..., None])
    kw, _ = fwd.kernel_inputs(batch)
    clean = k6.mono_forward(**kw)
    kw["dp"] = kw["dp"].clone()
    kw["dp"][1, int(torch.nonzero(kw["lm"][1] > 0)[0])] = float("nan")
    got = k6.mono_forward(**kw)
    ref = k6.mono_forward_plain(**kw)
    torch.cuda.synchronize()
    off = (kw["em"] == 0) & (kw["lm"] == 0)
    for g, c, r in zip(got, clean, ref):
        flagged = [bool((~torch.isfinite(t)).flatten(1).any(1)[k])
                   for t in (g, r) for k in range(4)]
        assert flagged[:4] == flagged[4:] == [False, True, False, False]
        for k in (0, 2, 3):
            assert torch.equal(g[k], c[k])
        assert not bool(g[off].nan_to_num(1.0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("engine,n", [("pksf", 32), ("tight-pksf", 64),
                                      ("mono", 32)])
def test_cuda_ladder_flags_a_diverged_graph(card, engine, n):
    """One atom of graph 1 far out (1e30 A: its distances overflow to
    inf, as a diverging ladder's do): the forward's planes are non-finite
    in graph 1 only, on the card as on the CPU (the plain versions), and
    a 4-step ladder flags graph 1 only."""
    from agdiff_torch.models.mono_forward import build_monolithic_forward
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import SamplerConfig, \
        build_fast_sampler

    cfg = dataclasses.replace(ModelConfig(), num_convs=2, num_convs_local=2,
                              dtype="bfloat16", smooth_conv=n == 64)
    mols = (load_fixture() if n == 32 else load_fixture("drugs_synthetic"))
    mols = [mols[0]] * 4 if engine.startswith("tight") else \
        [mols[i % len(mols)] for i in range(4)]

    def forward(dev):
        m = init_random(DualEncoderEpsNetwork(cfg), 0).to(dev).eval()
        if engine == "mono":
            return build_monolithic_forward(cfg, m)
        build = build_tight_forward if engine.startswith("tight") else \
            build_fast_forward
        return build(cfg, m, engine)

    flags = []
    for dev in (card, torch.device("cpu")):
        batch = pad_molecules(mols, n, device=dev)
        pos = batch.pos.clone()
        pos[1, 0] = 1e30
        batch = batch.replace(pos=pos)
        fwd = forward(dev)
        out = fwd(batch)
        planes = (out.edge_inv_global, out.edge_inv_local)
        flags.append([bool((~torch.isfinite(torch.stack(planes, 1)))
                           .flatten(1).any(1)[k]) for k in range(4)])
        sampler = build_fast_sampler(
            fwd, make_diffusion(cfg), SamplerConfig(n_steps=4, w_global=0.3),
            pair_capacity=(pair_capacity_for(mols[0].num_nodes, 256)
                           if engine.startswith("tight") else None),
            graph=False)
        gen = torch.Generator(device=dev).manual_seed(0)
        res = sampler(batch, pos, generator=gen)
        flags.append(res.nan_flags.cpu().tolist())
    assert flags[0] == flags[2] == [False, True, False, False]
    assert flags[1] == flags[3] == [False, True, False, False]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_cuda_train_step_matches_cpu(card, packed):
    """One train step (train/train_step.py) on the card against the same
    step on the CPU, at a small width (hidden 32, 2 + 2 convs, B = 8,
    bucket 32), f32 with TF32 off: the losses to 1e-5 of themselves, each
    gradient leaf to 2e-4 of max(its largest |g|, 1e-3 x the model's
    largest), the running statistics to 1e-5 of their largest, and the
    updates of every element whose gradient exceeds 1e-5 x the largest
    |g| to 1% of the learning rate (Adam's first step moves an element by
    about lr times the sign of its gradient)."""
    import copy

    from agdiff_torch.config import Config, TrainConfig
    from agdiff_torch.data.synthetic import synthetic_dataset
    from agdiff_torch.models.loss import sample_timesteps
    from agdiff_torch.models.weights import init_like_jax
    from agdiff_torch.train.optimizer import make_optimizer
    from agdiff_torch.train.train_step import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = Config(model=ModelConfig(hidden_dim=32, num_convs=2,
                                      num_convs_local=2, packed_pairs=packed),
                    train=TrainConfig(batch_size=8), buckets=(32,))
    batch = pad_molecules(synthetic_dataset(8, seed=4), 32)
    gen = torch.Generator().manual_seed(0)
    t = sample_timesteps(gen, 8, config.model.num_diffusion_timesteps)
    noise = torch.randn(batch.pos.shape, generator=gen)
    init = init_like_jax(DualEncoderEpsNetwork(config.model),
                         torch.Generator().manual_seed(1))
    runs = []
    for dev in (card, torch.device("cpu")):
        m = copy.deepcopy(init).to(dev)
        state = TrainState(0, m, make_optimizer(m, config.train),
                           torch.Generator(device=dev))
        before = {n: p.detach().cpu().clone() for n, p in m.named_parameters()}
        metrics = make_train_step(config, dev)(
            state, batch.to(dev), t.to(dev), noise.to(dev))
        runs.append((metrics, {n: p.grad.cpu() for n, p in
                               m.named_parameters()},
                     {n: b.cpu() for n, b in m.named_buffers()}, before,
                     {n: p.detach().cpu() for n, p in m.named_parameters()}))
    (mg, gg, bg, pg, ag), (mr, gr, br, _, ar) = runs
    for k in ("loss", "loss_global", "loss_local"):
        assert abs(float(getattr(mg, k)) - float(getattr(mr, k))) <= \
            1e-5 * abs(float(getattr(mr, k))), k
    top = max(float(g.abs().max()) for g in gr.values())
    for name, g in gr.items():
        scale = max(float(g.abs().max()), 1e-3 * top)
        assert float((gg[name] - g).abs().max()) <= 2e-4 * scale, name
        real = g.abs() > 1e-5 * top
        du = ((ag[name] - pg[name]) - (ar[name] - pg[name])).abs()[real]
        assert bool((du <= 0.01 * config.train.optimizer.lr).all()), name
    for name, b in br.items():
        assert float((bg[name] - b).abs().max()) <= \
            1e-5 * float(b.abs().max()), name


@pytest.mark.cuda
def test_cuda_warmed_tight_graphs_survive_another_atom_count(card):
    """GenerationRunner.warm on the 50-atom Drugs molecule keeps its
    graphs: a run of the 56-atom molecule (another tight list, captured
    at its run) leaves them, and the 50-atom molecule's next run captures
    nothing and gives the bits of a runner that never saw the other."""
    from agdiff_torch.eval.generate import GenerationRunner
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.graphed import LadderGraphs
    from agdiff_torch.sampling.langevin import SamplerConfig

    cfg = dataclasses.replace(ModelConfig(), hidden_dim=64, num_convs=2,
                              num_convs_local=2, dtype="bfloat16")
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    mols = load_fixture("drugs_synthetic")[:2]
    assert [m.num_nodes for m in mols] == [50, 56]

    def runner():
        return GenerationRunner(model, cfg, make_diffusion(cfg),
                                SamplerConfig(n_steps=5, w_global=0.3),
                                buckets=(64,), chunk_size=8, device=card)

    warmed = runner()
    assert warmed.warm(mols[0]) == [(64, 8, False)]
    pool = warmed.warmed_pool_bytes()
    assert pool > 0
    warmed.run([mols[1]], seed=1, num_confs=8)
    before = LadderGraphs.captures
    got = warmed.run([mols[0]], seed=2, num_confs=8)
    assert LadderGraphs.captures == before
    assert warmed.warmed_pool_bytes() == pool
    want = runner().run([mols[0]], seed=2, num_confs=8)
    np.testing.assert_array_equal(got[0].meta["pos_gen"],
                                  want[0].meta["pos_gen"])


@pytest.mark.cuda
def test_cuda_device_lock_keeps_captures_apart(card):
    """Two threads through one service at once, a warm (which captures)
    and an unbatched generate of another size (which captures too): the
    device lock runs them one after the other, so no capture overlaps the
    other thread's device work."""
    import threading
    import time

    from agdiff_torch.eval.generate import PackedGenerationRunner
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling import graphed
    from agdiff_torch.sampling.langevin import SamplerConfig
    from agdiff_torch.serve.server import GenerationService

    cfg = dataclasses.replace(ModelConfig(), hidden_dim=64, num_convs=2,
                              num_convs_local=2, dtype="bfloat16")
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    runner = PackedGenerationRunner(
        model, cfg, make_diffusion(cfg),
        SamplerConfig(n_steps=5, w_global=0.3), buckets=(64,),
        chunk_size=8, device=card)
    svc = GenerationService(runner, batch_window_s=0.2)
    spans, captures = [], []
    capture = graphed.LadderGraphs._capture

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize(card)
                spans.append((name, t0, time.perf_counter()))
        return run

    def recorded_capture(self, batch):
        t0 = time.perf_counter()
        capture(self, batch)
        captures.append((threading.current_thread().name, t0,
                         time.perf_counter()))

    runner.warm = timed("warm", runner.warm)
    runner.run = timed("run", runner.run)
    replies = {}
    requests = {
        "warm": {"cmd": "warm", "nodes": [30]},
        "run": {"cmd": "generate", "synthetic": 1, "synthetic_heavy": 20,
                "num_confs": 8, "save": False, "batch": False}}
    threads = [threading.Thread(
        target=lambda k=k: replies.__setitem__(k, svc.handle(requests[k])),
        name=k, daemon=True) for k in requests]
    graphed.LadderGraphs._capture = recorded_capture
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        graphed.LadderGraphs._capture = capture
    assert all(r["ok"] for r in replies.values()), replies
    assert {name for name, _, _ in captures} == {"warm", "run"}
    (a, a0, a1), (b, b0, b1) = sorted(spans, key=lambda s: s[1])
    assert a1 <= b0, spans
    for thread, c0, c1 in captures:
        other = [(s0, s1) for name, s0, s1 in spans if name != thread]
        assert all(c1 <= s0 or s1 <= c0 for s0, s1 in other)


# bf16 training and distillation on the card against the CPU: bf16 sums
# taken in another order flip roundings that the backward carries, so the
# limits are those tests/test_torch_port_bf16.py holds the CPU against JAX
# to (loss 1e-3 of itself, statistics 1e-3 of max(|stat|, 1), each leaf's
# max |diff| 6% of the model's largest |g|, the median over leaves of
# |diff| / |g| 7%); f32 keeps the train step's (loss 1e-5, each leaf 2e-4
# of max(its largest |g|, 1e-3 x the model's largest)).
BF16_TRAIN = dict(loss=1e-3, stats=1e-3, top=6e-2, median=7e-2)


def _grads_close(got, ref, bf16):
    top = max(float(g.abs().max()) for g in ref.values())
    rel = []
    for name, g in ref.items():
        err = float((got[name] - g).abs().max())
        if bf16:
            assert err <= BF16_TRAIN["top"] * top, (name, err, top)
            rel.append(float((got[name] - g).norm())
                       / max(float(g.norm()), 1e-30))
        else:
            scale = max(float(g.abs().max()), 1e-3 * top)
            assert err <= 2e-4 * scale, (name, err, scale)
    if bf16:
        assert float(np.median(rel)) <= BF16_TRAIN["median"], rel


def _small_train_config(dtype, packed=False):
    from agdiff_torch.config import Config, TrainConfig

    return Config(model=ModelConfig(hidden_dim=32, num_convs=2,
                                    num_convs_local=2, packed_pairs=packed,
                                    dtype=dtype),
                  train=TrainConfig(batch_size=8), buckets=(32,))


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_cuda_bf16_train_step_matches_cpu(card, packed):
    """One bf16 train step on the card against the CPU (TF32 off): the
    losses, every gradient leaf and the running statistics at
    BF16_TRAIN's limits."""
    import copy

    from agdiff_torch.data.synthetic import synthetic_dataset
    from agdiff_torch.models.loss import sample_timesteps
    from agdiff_torch.models.weights import init_like_jax
    from agdiff_torch.train.optimizer import make_optimizer
    from agdiff_torch.train.train_step import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    config = _small_train_config("bfloat16", packed)
    batch = pad_molecules(synthetic_dataset(8, seed=4), 32)
    gen = torch.Generator().manual_seed(0)
    t = sample_timesteps(gen, 8, config.model.num_diffusion_timesteps)
    noise = torch.randn(batch.pos.shape, generator=gen)
    init = init_like_jax(DualEncoderEpsNetwork(config.model),
                         torch.Generator().manual_seed(1))
    runs = []
    for dev in (card, torch.device("cpu")):
        m = copy.deepcopy(init).to(dev)
        state = TrainState(0, m, make_optimizer(m, config.train),
                           torch.Generator(device=dev))
        metrics = make_train_step(config, dev)(
            state, batch.to(dev), t.to(dev), noise.to(dev))
        runs.append((metrics, {n: p.grad.cpu() for n, p in
                               m.named_parameters()},
                     {n: b.cpu() for n, b in m.named_buffers()}))
    (mg, gg, bg), (mr, gr, br) = runs
    for k in ("loss", "loss_global", "loss_local"):
        assert abs(float(getattr(mg, k)) - float(getattr(mr, k))) <= \
            BF16_TRAIN["loss"] * abs(float(getattr(mr, k))), k
    _grads_close(gg, gr, bf16=True)
    for name, b in br.items():
        assert float((bg[name] - b).abs().max()) <= BF16_TRAIN["stats"] * \
            max(float(b.abs().max()), 1.0), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_distill_step_matches_cpu(card, dtype):
    """One distillation step (train/distill.py: two teacher DDIM steps, the
    student's drift, backward, the clip and the two Adams) on the card
    against the CPU, the same k and noise: the loss, the gradient norm and
    every gradient leaf, f32 at the train step's limits and bf16 at
    BF16_TRAIN's; the teacher and the student's statistics unchanged."""
    from agdiff_torch.data.synthetic import synthetic_dataset
    from agdiff_torch.models.weights import init_like_jax
    from agdiff_torch.sampling.langevin import SamplerConfig
    from agdiff_torch.train import distill

    torch.backends.cuda.matmul.allow_tf32 = False
    config = _small_train_config(dtype)
    sampler = SamplerConfig(sampling_type="generalized", eta=0.0,
                            ladder="strided", w_global=0.3, clip_local=20.0)
    batch = pad_molecules(synthetic_dataset(8, seed=4), 32)
    gen = torch.Generator().manual_seed(0)
    k = torch.randint(0, 16, (8,), generator=gen)
    noise = torch.randn(batch.pos.shape, generator=gen)
    teacher = init_like_jax(DualEncoderEpsNetwork(config.model),
                            torch.Generator().manual_seed(1)).eval()
    runs = []
    for dev in (card, torch.device("cpu")):
        t_dev = distill.student_from(teacher).to(dev).requires_grad_(False)
        before = {n: v.clone() for n, v in t_dev.state_dict().items()}
        state = distill.create_distill_state(config, t_dev, dev, 0)
        stats = {n: b.clone() for n, b in state.module.named_buffers()}
        metrics = distill.make_distill_step(config, sampler, 16, dev)(
            state, t_dev, batch.to(dev), k.to(dev), noise.to(dev))
        for n, v in t_dev.state_dict().items():
            assert torch.equal(v, before[n]), n
        for n, b in state.module.named_buffers():
            assert torch.equal(b, stats[n]), n
        runs.append((metrics, {n: p.grad.cpu() for n, p in
                               state.module.named_parameters()}))
    (mg, gg), (mr, gr) = runs
    bf16 = dtype == "bfloat16"
    rtol = BF16_TRAIN["loss"] if bf16 else 1e-5
    assert abs(float(mg.loss) - float(mr.loss)) <= rtol * float(mr.loss)
    assert abs(float(mg.grad_norm) - float(mr.grad_norm)) <= \
        (BF16_TRAIN["median"] if bf16 else 1e-4) * float(mr.grad_norm)
    _grads_close(gg, gr, bf16)


# ---- data parallelism: two gloo ranks on card 0 ------------------------------


def _dp_cases():
    """A small f32 train step (B = 8, ranks of uneven real-node counts)
    and a 'pksf' ladder at full width (B = 16, one QM9 molecule
    repeated), their weights in the flax layout the rank helpers load."""
    from agdiff_torch.data.synthetic import synthetic_dataset
    from agdiff_torch.models.weights import export_jax_variables, init_like_jax
    from agdiff_torch.sampling.langevin import SamplerConfig

    config = _small_train_config("float32")
    batch = pad_molecules(synthetic_dataset(8, seed=4), 32)
    gen = torch.Generator().manual_seed(0)
    init = init_like_jax(DualEncoderEpsNetwork(config.model),
                         torch.Generator().manual_seed(1))
    train = dict(kind="train", config=config,
                 variables=export_jax_variables(init), batch=batch,
                 t=torch.randint(0, config.model.num_diffusion_timesteps, (8,),
                                 generator=gen),
                 noise=torch.randn(batch.pos.shape, generator=gen))
    cfg = dataclasses.replace(ModelConfig(), num_convs=3, num_convs_local=2,
                              dtype="bfloat16")
    ladder = pad_molecules([load_fixture()[0]] * 16, 32, batch_size=16)
    sample = dict(kind="sample", model_config=cfg, engine="pksf",
                  variables=export_jax_variables(init_random(
                      DualEncoderEpsNetwork(cfg), 0)),
                  sampler=SamplerConfig(n_steps=4, w_global=0.3),
                  batch=ladder,
                  pos_init=torch.randn(ladder.pos.shape, generator=gen),
                  noise=torch.randn((4,) + tuple(ladder.pos.shape),
                                    generator=gen))
    return {"train": train, "sample": sample}


@pytest.fixture(scope="module")
def dp_world():
    """The cases and each rank's results of one world of two gloo ranks on
    card 0 (launch's explicit backend: NCCL refuses two ranks on one
    device)."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")
    from agdiff_torch.parallel import launch

    import torch_port_dp_ranks as ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = _dp_cases()
    return cases, launch(ranks.run_cases, 2, cases, device="cuda:0",
                         backend="gloo")


@pytest.mark.cuda
def test_cuda_dp_train_step_matches_the_single_process_step(card, dp_world):
    """The two ranks' step against one process's on the card: losses to
    1e-5 of themselves, gradients and running statistics at
    test_cuda_train_step_matches_cpu's limits, every rank the same."""
    import torch_port_dp_ranks as ranks

    cases, out = dp_world
    single = ranks.train_case(None, dict(cases["train"], device="cuda"))
    for got in (out[0]["train"], out[1]["train"]):
        for g, w in zip(got["metrics"][:3], single["metrics"][:3]):
            assert abs(g - w) <= 1e-5 * abs(w)
        _grads_close(got["grads"], single["grads"], bf16=False)
        for name, b in single["buffers"].items():
            assert float((got["buffers"][name] - b).abs().max()) <= \
                1e-5 * float(b.abs().max()), name
    for n, p in out[0]["train"]["params"].items():
        assert torch.equal(p, out[1]["train"]["params"][n]), n


@pytest.mark.cuda
def test_cuda_dp_pksf_ladder_is_the_single_process_run_per_rank(card,
                                                                dp_world):
    """The gathered samples of the two ranks' 'pksf' ladder (K1 on each
    rank, the same forwards on each) equal, bit for bit, single-process
    runs at each rank's batch size on the same starts and noise."""
    import torch_port_dp_ranks as ranks

    cases, out = dp_world
    case = cases["sample"]
    got = out[0]["sample"]["pos"]
    assert torch.equal(got, out[1]["sample"]["pos"])
    calls = [r["sample"]["calls"] for r in out]
    assert calls[0] == calls[1] >= 4, calls
    for r in range(2):
        rows = slice(8 * r, 8 * r + 8)
        alone = ranks.sample_case(None, dict(
            case, device="cuda", batch=case["batch"].replace(**{
                k: v[rows] for k, v in vars(case["batch"]).items()}),
            pos_init=case["pos_init"][rows], noise=case["noise"][:, rows]))
        assert torch.equal(got[rows], alone["pos"]), r
        assert not alone["flags"].any()



@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_k3_in_a_pipeline_stage(card, dtype):
    """parallel/pipeline.py's SchNet stage body on the card: three blocks,
    one K3 launch each, against the same body asked for a gradient (K3's
    plain version, no launch) within K3's limits (f32: 1e-5 of the
    largest |h|; bf16: the bf16 limits above); K3 itself refuses a
    gradient."""
    from agdiff_torch.kernels import fused
    from agdiff_torch.parallel.pipeline import schnet_stage

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(hidden_dim=32, num_convs=6, num_convs_local=2,
                      dtype=dtype)
    model = init_random(DualEncoderEpsNetwork(cfg), 0).to(card).eval()
    fwd = build_fast_forward(cfg, model, "pallas")
    stage = schnet_stage(fwd)
    gen = torch.Generator(device=card).manual_seed(0)
    b, n, c = 4, 20, 32
    h = torch.randn(b, n, c, generator=gen, device=card)
    e = (torch.randn(b, n, n, c, generator=gen, device=card) * 0.1).to(
        fwd.compute_dtype)
    el = torch.rand(b, n, n, 1, generator=gen, device=card) * 3.0 + 0.5
    env = torch.rand(b, n, n, generator=gen, device=card)
    blocks = tuple(fwd.blocks[:3])
    name = fused.variant("block_agg", fwd.compute_dtype)
    before = fused.launches[name]
    with torch.no_grad():
        got = stage(blocks, (h, e, el, env))[0]
    torch.cuda.synchronize()
    assert fused.launches[name] - before == 3
    plain = stage(blocks, (h.clone().requires_grad_(True), e, el, env))[0]
    assert fused.launches[name] - before == 3
    if dtype == "float32":
        scale = float(plain.abs().max())
        assert float((got - plain.detach()).abs().max()) <= 1e-5 * scale
    else:
        _within_limits(got, plain.detach())
    c1, c2 = blocks[0]["convs"]
    w = torch.ones(b, n, n, device=card, requires_grad=True)
    x1 = torch.zeros(b, n, c1["fb"][0].shape[1], device=card)
    x2 = torch.zeros(b, n, c2["fb"][0].shape[1], device=card)
    with pytest.raises(RuntimeError, match="no backward"):
        fused.block_agg_launch(e, w, w, x1, x2, c1, c2)
