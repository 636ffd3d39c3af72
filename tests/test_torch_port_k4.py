"""K4, the dense pair-score kernel, walks only each graph's masked pairs
(csrc/fused.cu, kernels/fused.py pair_score_launch). What that rests on,
on the CPU: the list mirrors the kernel's ballot order; the plain twin over
a graph's list, padded to whole tiles with rows that add nothing, gives the
dense twin's bits on those pairs, and the dense plane is 0 off them; the
layout sums at the main widths; and the plain twin against JAX's
pair_score_mlp (Pallas, interpret mode) on an asymmetric mask and on a
graph with no masked pair. The kernel itself is held against the twin on
the card (tests/test_torch_port_cuda.py, chip_smoke.py)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agdiff_tpu.ops.pallas import fused as jax_fused

from agdiff_torch.config import ModelConfig
from agdiff_torch.data.bucketing import pad_molecules
from agdiff_torch.data.fixture import load_fixture
from agdiff_torch.kernels import fused
from agdiff_torch.models import fast_forward as ff
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.fast_forward import build_fast_forward
from agdiff_torch.models.weights import init_random

from test_torch_port_common import jax_run, row_product

torch.set_num_threads(2)

# the twin against JAX's kernel: f32 summation order; at bf16 also the
# last bits of a hidden value's rounding (tests/test_torch_port_fused.py)
TWIN_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-4}


@functools.lru_cache(maxsize=None)
def _head_inputs(n, dtype):
    """Both score heads' arguments (global, local) in a dense 'pallas'
    forward (pack_pairs=False) at hidden 32 on the QM9 fixture in bucket
    n, positions spread 6 A (seeded), so that the global mask is ragged."""
    cfg = dataclasses.replace(ModelConfig(), hidden_dim=32, num_convs=2,
                              num_convs_local=2, dtype=dtype)
    model = init_random(DualEncoderEpsNetwork(cfg), 0).eval()
    batch = pad_molecules(load_fixture(), n)
    rng = np.random.default_rng(n)
    pos = torch.from_numpy(6.0 * rng.standard_normal(
        tuple(batch.pos.shape)).astype(np.float32))
    batch = batch.replace(pos=pos * batch.node_mask[..., None])
    calls = []
    real = ff.pair_score_mlp

    def record(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    ff.pair_score_mlp = record
    try:
        with torch.no_grad():
            build_fast_forward(cfg, model, "pallas", pack_pairs=False)(batch)
    finally:
        ff.pair_score_mlp = real
    return tuple(calls)


def _case(case, dtype):
    """(h, e, mask, weights) of a case: a head's inputs ('global',
    'local', 'n40': the global head in bucket 40), or the global head's
    with a random asymmetric mask and random e ('asymmetric'), or with
    graph 1's mask empty ('empty_graph')."""
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    calls = _head_inputs(40 if case == "n40" else 32, name)
    h, e, mask, *w = calls[1 if case == "local" else 0]
    if case == "asymmetric":
        rng = np.random.default_rng(7)
        mask = torch.from_numpy(rng.random(tuple(mask.shape)) < 0.3)
        e = torch.from_numpy(rng.normal(0, 0.5, tuple(e.shape)).astype(
            np.float32)).to(dtype)
        assert not torch.equal(mask, mask.transpose(1, 2))
        assert not torch.equal(e, e.transpose(1, 2))
    elif case == "empty_graph":
        mask = mask.clone()
        mask[1] = False
    return h, e, mask, w


def test_pair_list_mirrors_the_ballot_order():
    """pair_score_pairs against the kernel's scan, simulated word by word:
    a ballot of 32 cells, exclusive bases of the words' counts, each cell
    at its base plus the set bits below it; ragged N, an empty graph and a
    full one."""
    rng = np.random.default_rng(3)
    for n in (20, 32, 40):
        mask = rng.random((3, n, n)) < 0.3
        mask[1] = False
        mask[2, :5] = True
        got = fused.pair_score_pairs(torch.from_numpy(mask))
        for g in range(3):
            flat = mask[g].reshape(-1)
            words = [sum(int(b) << k for k, b in enumerate(flat[w:w + 32]))
                     for w in range(0, n * n, 32)]
            base = np.concatenate([[0], np.cumsum(
                [bin(x).count("1") for x in words])])
            cells = np.full(int(base[-1]), -1)
            for q in np.flatnonzero(flat):
                below = words[q >> 5] & ((1 << (q & 31)) - 1)
                cells[base[q >> 5] + bin(below).count("1")] = q
            assert got[g].tolist() == cells.tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["global", "local", "asymmetric",
                                  "empty_graph", "n40"])
def test_plain_over_masked_pairs_equals_the_dense_plane(case, dtype,
                                                        monkeypatch):
    """What K4's compaction rests on: graph by graph, the plain twin's MLP
    over the graph's list (pair_score_pairs, the kernel's order), padded to
    whole tiles (64 pairs at bf16, 32 at f32) with zero rows, gives the
    bits of the dense twin on those pairs, and the dense plane is 0 off
    them. Covers both
    heads' masks, an asymmetric mask with an asymmetric e, a graph with no
    masked pair, counts that are not multiples of 64, and N = 40. Products
    are row-independent (row_product) in both runs."""
    monkeypatch.setattr(torch.Tensor, "__matmul__", row_product)
    h, e, mask, w = _case(case, dtype)
    n, c = h.shape[1:]
    lists = fused.pair_score_pairs(mask)
    counts = [len(cells) for cells in lists]
    assert any(k % 64 for k in counts)
    assert (0 in counts) == (case == "empty_graph")
    rows = fused.TC_ROWS if dtype == torch.bfloat16 else fused.FT_ROWS
    for g, cells in enumerate(lists):
        dense = fused.pair_score_mlp_plain(h[g:g + 1], e[g:g + 1],
                                           mask[g:g + 1], *w)[0].reshape(-1)
        pad = -len(cells) % rows
        i, j = cells // n, cells % n
        prod = torch.cat([h[g, i] * h[g, j], h.new_zeros(pad, c)])
        rows_e = torch.cat([e[g].reshape(n * n, c)[cells],
                            e.new_zeros(pad, c)])
        got = fused.pair_score_rows(prod, rows_e, *w)
        assert torch.equal(dense[cells], got[:len(cells)]), (case, g)
        off = torch.ones(n * n, dtype=torch.bool)
        off[cells] = False
        assert bool((dense[off] == 0).all())


@pytest.mark.parametrize("dtype,n,want", [
    (torch.bfloat16, 32, (0, 144656, True)),
    (torch.bfloat16, 64, (0, 159760, True)),
    (torch.bfloat16, 128, (0, 203792, True)),
    (torch.bfloat16, 256, (0, 199680, False)),
    (torch.float32, 32, (0, 221456, True)),
    (torch.float32, 64, (0, 228368, True)),
    (torch.float32, 128, (0, 219136, False))])
def test_k4_layout_at_the_main_widths(dtype, n, want):
    """Pinned sums at C = H1 = 128, H2 = 64 (csrc/fused.cu mirrors them):
    the level, the launch's shared memory and whether the lists fit in it
    (else they go to the scratch, pair_lists_bytes a CTA)."""
    assert fused.pair_score_layout(n, 128, 128, 64, dtype) == want
    assert want[1] <= fused.MAX_SMEM


def test_k4_level_sums_and_bounds():
    """Each level's regions at the main widths, and the widths where the
    level changes (pair_score_level's docstring)."""
    bf, f32 = torch.bfloat16, torch.float32
    assert fused.pair_lists_bytes(32) == 2320
    assert fused.pair_lists_bytes(40) == 3632
    assert [fused.pair_score_smem(128, 128, 64, bf, lv)
            for lv in (0, 1)] == [134144, 52224]
    assert [fused.pair_score_smem(128, 128, 64, f32, lv)
            for lv in (0, 1, 2)] == [219136, 186368, 55296]
    assert fused.pair_score_h_bytes(32, 128, bf) == 8192
    assert fused.pair_score_h_bytes(32, 128, f32) == 0
    for dtype, c, level in ((bf, 224, 0), (bf, 228, 1), (bf, 656, 1),
                            (bf, 660, None), (f32, 136, 0), (f32, 140, 1),
                            (f32, 160, 1), (f32, 164, 2), (f32, 740, 2),
                            (f32, 744, None)):
        assert fused.pair_score_level(32, c, 128, 64, dtype) == level, c


def test_pack_pair_score_weights_places_both_halves_of_w1():
    """w1's product rows at [0, C) and its edge rows at [Cp, Cp + C) of
    the packed first matrix, at a C that is not a multiple of 16; w2
    after it."""
    rng = np.random.default_rng(5)
    c, h1, h2 = 20, 36, 12
    w1 = torch.from_numpy(rng.normal(size=(2 * c, h1)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(h1, h2)).astype(np.float32))
    packed = fused.pack_pair_score_weights(w1, w2)
    cp, h1p = fused.pad16(c), fused.pad16(h1)
    first = fused.unpack_matrix(packed[:2 * cp * h1p], 2 * cp, h1p)
    assert torch.equal(first[:c, :h1], w1[:c])
    assert torch.equal(first[cp:cp + c, :h1], w1[c:])
    assert not first[c:cp].any() and not first[:, h1:].any()
    assert torch.equal(fused.unpack_matrix(packed[2 * cp * h1p:], h1, h2), w2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_plain_matches_jax_on_asymmetric_and_empty_graphs(dtype,
                                                             monkeypatch):
    """The plain twin against JAX's Pallas kernel (interpret mode) at N =
    12: graph 0 with a random asymmetric mask and asymmetric e, graph 1
    with no masked pair (both read exactly 0 there)."""
    monkeypatch.setattr(jax_fused, "_INTERPRET", True)
    rng = np.random.default_rng(11)
    b, n, c, h1, h2 = 2, 12, 16, 32, 16
    h = rng.normal(0, 1, (b, n, c)).astype(np.float32)
    e = rng.normal(0, 0.5, (b, n, n, c)).astype(np.float32)
    mask = rng.random((b, n, n)) < 0.4
    mask[1] = False
    assert not (mask[0] == mask[0].T).all()
    ws = [rng.uniform(-1, 1, shape).astype(np.float32) / np.sqrt(shape[0])
          for shape in ((2 * c, h1), (h1,), (h1, h2), (h2,), (h2, 1), (1,))]
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jw = [jnp.asarray(x).astype(jd) if k % 2 == 0 else jnp.asarray(x)
          for k, x in enumerate(ws)]
    ref = np.asarray(jax_run(lambda: jax_fused.pair_score_mlp(
        jnp.asarray(h).astype(jd), jnp.asarray(e).astype(jd),
        jnp.asarray(mask), *jw, activation="relu")))
    tw = [torch.from_numpy(x).to(dtype) if k % 2 == 0 else
          torch.from_numpy(x) for k, x in enumerate(ws)]
    got = fused.pair_score_mlp(torch.from_numpy(h).to(dtype),
                               torch.from_numpy(e).to(dtype),
                               torch.from_numpy(mask), *tw).numpy()
    assert not got[1].any() and not ref[1].any()
    assert not got[~mask].any()
    scale = np.abs(ref).max()
    assert scale > 1e-3
    np.testing.assert_allclose(got, ref, atol=TWIN_TOL[dtype] * scale,
                               rtol=0)
