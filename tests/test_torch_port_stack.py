"""K1 (the whole-stack packed forward, mode 'full'): the port's plain
version against the JAX Pallas kernel run in interpret mode on the same
folded weights and inputs, at f32 (2e-4) and bf16; the port's engines
against its dense forward. The CUDA kernel itself is tested on the card
by tests/test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agdiff_tpu.models.fast_forward import fold_eval_params as jax_fold
from agdiff_tpu.ops.pallas import stack_packed as jax_stack

from agdiff_torch.kernels import stack_packed as k1
from agdiff_torch.models.fast_forward import build_fast_forward
from agdiff_torch.ops.pairs import (
    pair_capacity_for,
    prepare_pairs_shared,
    triu_pairs,
)

from test_torch_port_common import (
    batches,
    configs,
    jax_variables,
    molecules,
    port_model,
)

B, N = 2, 8
P = N * (N - 1) // 2
# bf16, plain version against the JAX kernel: both round at the same
# places, so at this size they agree to f32 summation order (measured
# ~4e-7 of the largest score); held to 1e-4 of it.
BF16_PLAIN = 1e-4


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = configs()
    jb, _ = batches(molecules())
    _, variables = jax_variables(jcfg, jb)
    return jcfg, cfg, variables


def _inputs(h, nb, seed=0):
    """Seeded numpy K1 inputs: edge features, distance-weight planes with
    zeroed (pad) slots, node states and a 0/1 local mask."""
    rng = np.random.default_rng(seed)
    e = rng.normal(0, 0.5, (B, P, h)).astype(np.float32)
    we = rng.uniform(0, 1, (2 * nb, B, P)).astype(np.float32)
    we[:, :, rng.random(P) < 0.3] = 0.0
    h0 = rng.normal(0, 1, (B, N, h)).astype(np.float32)
    hl0 = rng.normal(0, 1, (B, N, h)).astype(np.float32)
    lm = rng.random((B, P)) < 0.4
    return e, we, h0, hl0, lm


def _jax_planes(folded, e, we, h0, hl0, lm, dtype, monkeypatch):
    monkeypatch.setattr(jax_stack, "_INTERPRET", True)
    ep = jnp.asarray(e).astype(dtype)
    sg, sl = jax_stack.packed_stack_forward(
        ep, jnp.asarray(we), jnp.asarray(h0), folded["blocks"], mode="full",
        e_packed_local=ep, local_mask_p=jnp.asarray(lm), hl0=jnp.asarray(hl0),
        gin_layers=folded["gin_layers"], grad_global=folded["grad_global"],
        grad_local=folded["grad_local"], act_fn=jax.nn.relu)
    return np.asarray(sg), np.asarray(sl)


def _port_planes(stack, e, we, h0, hl0, lm, dtype):
    ep = torch.from_numpy(e).to(dtype)
    return [t.numpy() for t in k1.packed_stack_forward(
        ep, torch.from_numpy(we), torch.from_numpy(h0), stack, ep,
        torch.from_numpy(lm), torch.from_numpy(hl0), triu_pairs(N))]


def test_plain_matches_jax_kernel_f32(weights, monkeypatch):
    jcfg, cfg, variables = weights
    folded = jax_fold(jcfg, variables)
    stack = build_fast_forward(cfg, port_model(cfg, variables), None).stack
    inp = _inputs(cfg.hidden_dim, cfg.num_convs)
    ref = _jax_planes(folded, *inp, jnp.float32, monkeypatch)
    got = _port_planes(stack, *inp, torch.float32)
    for g, r in zip(got, ref):
        assert np.abs(r).max() > 1e-3
        np.testing.assert_allclose(g, r, atol=2e-4)


def test_plain_matches_jax_kernel_bf16(weights, monkeypatch):
    """The 'pksf' casts on both sides: filter weights and score heads in
    bf16, every product on bf16 operands."""
    jcfg, cfg, variables = weights
    folded = jax_fold(jcfg, variables)
    for blk in folded["blocks"]:
        for conv in blk["convs"]:
            conv["fa"] = (conv["fa"][0].astype(jnp.bfloat16), conv["fa"][1])
            conv["fb"] = (conv["fb"][0].astype(jnp.bfloat16), conv["fb"][1])
    for key in ("grad_global", "grad_local"):
        folded[key] = tuple(p.astype(jnp.bfloat16) for p in folded[key])
    stack = build_fast_forward(cfg, port_model(cfg, variables), "pksf").stack
    inp = _inputs(cfg.hidden_dim, cfg.num_convs, seed=1)
    ref = _jax_planes(folded, *inp, jnp.bfloat16, monkeypatch)
    got = _port_planes(stack, *inp, torch.bfloat16)
    for g, r in zip(got, ref):
        scale = np.abs(r).max()
        assert scale > 1e-3
        np.testing.assert_allclose(g, r, atol=BF16_PLAIN * scale)


def test_engines_match_dense_forward(weights):
    """Engine None (f32, K1's plain version through the f32 path) equals
    the dense module to 2e-4; engine 'pksf' (bf16, through the wrapper,
    which takes the plain version for CPU tensors) stays within the JAX
    slim gate's 5% of the largest score."""
    _, cfg, variables = weights
    _, tb = batches(molecules(3, seed=4))
    model = port_model(cfg, variables)
    with torch.no_grad():
        dense = model(tb)
    f32 = build_fast_forward(cfg, model, None)(tb)
    bf16 = build_fast_forward(cfg, model, "pksf")(tb)
    for name, mask in (("edge_inv_global", dense.edge_mask),
                       ("edge_inv_local", dense.local_mask)):
        ref = torch.where(mask, getattr(dense, name), 0.0)
        np.testing.assert_allclose(
            torch.where(mask, getattr(f32, name), 0.0).numpy(), ref.numpy(),
            atol=2e-4)
        err = (torch.where(mask, getattr(bf16, name), 0.0) - ref).abs().max()
        assert float(err) < 0.05 * float(ref.abs().max()), name


def test_wrapper_counts_only_kernel_launches(weights):
    _, cfg, variables = weights
    stack = build_fast_forward(cfg, port_model(cfg, variables), "pksf").stack
    before = dict(k1.launches)
    _port_planes(stack, *_inputs(cfg.hidden_dim, cfg.num_convs),
                 torch.bfloat16)
    assert dict(k1.launches) == before
    with pytest.raises(ValueError, match="mode"):
        k1.packed_stack_forward(None, None, None, stack, None, None, None,
                                None, mode="dense")


def test_smem_layout_fits_the_main_path():
    """At H = 128 every node region fits shared memory to N = 64 (level
    0), but beside the staged weights only to N = 32; the layout takes
    the smallest level with staged weights: node temporaries in global
    scratch from N = 48 (level 1), node states too from N = 96 (level 2),
    which fits any N. Pair lists never count against shared memory."""
    assert k1.smem_bytes(32, 128) == 130308
    assert k1.smem_bytes(64, 128) == 213764 <= k1.MAX_SMEM
    assert k1.smem_bytes(72, 128) == 255492 > k1.MAX_SMEM
    assert k1.weight_region_bytes(128) == 95232
    assert k1.layout(32, 128) == (0, 130308, 0)
    assert k1.layout(48, 128)[0] == 1
    assert k1.layout(64, 128) == (1, 113412, 100352)
    assert k1.layout(80, 128) == (1, 130052, 125440)
    level, smem, scratch = k1.layout(96, 128)
    assert level == 2 and smem == k1.smem_bytes(96, 128, 2) == 46848
    assert scratch >= sum(k1.region_bytes(96, 128)[:3])
    assert k1.layout(1024, 128)[0] == 2


@pytest.mark.parametrize("b,want", [(8, 8), (16, 8), (32, 4), (48, 2),
                                    (64, 2), (128, 1)])
def test_ranks_for_fills_the_card(b, want):
    """CTAs per graph on a 132-SM H100: the largest power of two R with
    B * R <= 132, at most the portable cluster size 8."""
    assert k1.ranks_for(b, 132) == want
    assert b * want <= 132 and want <= k1.MAX_RANKS


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("n", [16, 32, 64, 80])
def test_rank_shares_cover_every_tile_and_entry_once(n, tight):
    """At R = 1, 2, 4 and 8 the ranks' contiguous tile shares cover every
    tile of the valid pairs once, and their incidence ranges (from each
    node's first entry at or past the rank's first pair) cover each
    node's entries exactly once, in order, each entry in its rank's
    pairs. Triu: the bucket's whole triangle; tight: the real pairs of a
    molecule of n - 5 atoms, padded to a capacity. At n = 16 some ranks
    get no tile (2 or 4 tiles for 8 ranks) and so no entry."""
    if tight:
        mask = torch.zeros((1, n), dtype=torch.bool)
        mask[0, :n - 5] = True
        pairs = prepare_pairs_shared(mask, pair_capacity_for(n - 5, 256))
        assert pairs.num_valid < pairs.num_pairs
    else:
        pairs = triu_pairs(n)
    num_tiles = -(-pairs.num_valid // k1.TILE_P)
    ptr, pair = pairs.inc_ptr.tolist(), pairs.inc_pair.tolist()
    for ranks in (1, 2, 4, 8):
        shares = k1.rank_tiles(num_tiles, ranks)
        tiles = [t for t0, t1 in shares for t in range(t0, t1)]
        assert tiles == list(range(num_tiles))
        entries = k1.rank_entries(pairs, ranks)
        for node in range(n):
            covered = [q for rank in entries for q in range(*rank[node])]
            assert covered == list(range(ptr[node], ptr[node + 1]))
        for (t0, t1), rank in zip(shares, entries):
            for start, end in rank:
                assert all(t0 * k1.TILE_P <= pair[q] < t1 * k1.TILE_P
                           for q in range(start, end))

