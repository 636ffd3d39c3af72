"""The Python mirrors of the tensor-core layout of K2 and K3 at bf16
(kernels/fused.py, kernels/block_packed.py; csrc/filter_mlp.cuh): the
packed filter weights unpack to the original matrices and hold each
lane's mma.m16n8k16 B fragments where the kernel loads them; K3's
persistent schedule sums every node row exactly once; the layout level
each shape gets and its shared-memory sum agree with the wrappers' accept
and refuse rule at the boundary N, and every shape the CUDA-core kernels
took is still taken. CPU only; the kernels themselves run in
tests/test_torch_port_cuda.py."""

import numpy as np
import pytest
import torch

from agdiff_torch.kernels import block_packed as k2
from agdiff_torch.kernels import fused

WIDTHS = [(128, 128, 64), (36, 20, 12), (4, 4, 4), (132, 68, 60)]


def _parent_k2_fits(n, c, f1, f2):
    """The CUDA-core K2's rule (block_packed.py smem_bytes, its f32 form
    and, before the tensor-core kernel, its bf16 form too)."""
    return k2.smem_bytes(n, c, f1, f2) <= fused.MAX_SMEM


def _parent_k3_fits(c, f1, f2):
    """The CUDA-core K3's shared memory (csrc/fused.cu
    block_agg_smem_f32, its bf16 form before the tensor-core kernel)."""
    fw = f1 + f2
    return 4 * (c * 36 + fw * 36 + 32 * (fw + 4) + 64) <= fused.MAX_SMEM


@pytest.mark.parametrize("c,f1,f2", WIDTHS)
def test_packed_filter_weights_unpack_to_the_originals(c, f1, f2):
    rng = np.random.default_rng(c + f1 + f2)
    mats = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((c, f1), (c, f2), (f1, f1), (f2, f2))]
    packed = fused.pack_filter_weights(*mats)
    assert packed.numel() * 2 == fused.tc_regions(c, f1, f2)["weights"]
    for got, want in zip(fused.unpack_filter_weights(packed, c, f1, f2),
                         mats):
        assert torch.equal(got, want)
    # lane (g, t) of block (strip ct, k block kt) of fa holds the B
    # fragments (k, n) = (2t, g), (2t+1, g), (2t+8, g), (2t+9, g), then
    # the same at n + 8 (csrc/filter_mlp.cuh tc_unit)
    cp, f1p, f2p = (fused.pad16(x) for x in (c, f1, f2))
    fa = torch.zeros(cp, f1p + f2p)
    fa[:c, :f1], fa[:c, f1p:f1p + f2] = mats[0], mats[1]
    kts = cp // 16
    for ct in range((f1p + f2p) // 16):
        for kt in range(kts):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                want = [fa[16 * kt + 2 * t + dk, 16 * ct + dn + g]
                        for dn in (0, 8) for dk in (0, 1, 8, 9)]
                start = ((ct * kts + kt) * 32 + lane) * 8
                assert torch.equal(packed[start:start + 8],
                                   torch.stack(want))


def test_prepared_filter_weights_are_cached_per_weight_set():
    """One weight table and pack per set of the convs' tensors and dtype;
    an in-place edit prepares anew."""
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def conv(f):
        return {"fa": (t(8, f), t(f)), "fb": (t(f, f), t(f)),
                "beta": torch.tensor(1.0)}

    c1, c2 = conv(8), conv(4)
    dev, bf = torch.device("cpu"), torch.bfloat16
    wts, packed = fused.prepared_filter(c1, c2, 8, bf, dev)
    assert packed.dtype == bf and [w.dtype for w in wts[:4]] == [bf] * 4
    assert fused.prepared_filter(c1, c2, 8, bf, dev)[1] is packed
    assert fused.prepared_filter(c1, c2, 8, torch.float32, dev)[1] is None
    c1["fb"][0].mul_(2.0)
    again = fused.prepared_filter(c1, c2, 8, bf, dev)[1]
    assert again is not packed
    assert torch.equal(fused.unpack_filter_weights(again, 8, 8, 4)[2],
                       c1["fb"][0].bfloat16())


@pytest.mark.parametrize("b,n,grid", [
    (128, 32, 132), (1, 32, 132), (5, 20, 7), (3, 40, 264), (2, 104, 132),
    (4, 1, 3), (7, 65, 5), (16, 64, 132), (9, 33, 1)])
def test_block_agg_schedule_covers_every_row_once(b, n, grid):
    rpg, tiles, groups = fused.block_agg_groups(b, n)
    assert rpg * min(n, fused.TC_ROWS) <= fused.TC_ROWS
    assert tiles * fused.TC_ROWS >= n
    grid = min(grid, groups)   # the kernel's grid never exceeds them
    sched = fused.block_agg_schedule(b, n, grid)
    assert len(sched) == grid
    assert [r for blk in sched for r in blk] == list(range(b * n))
    # every block has work, and the shares differ by one group at most
    sizes = [-(-len(blk) // rpg) for blk in sched]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_tensor_core_shared_memory_at_the_main_widths():
    """Pinned sums at C = F1 = 128, F2 = 64 (csrc/*.cu mirror them): 88 KB
    of packed weights; K3 at level 0; K2 at N = 32 with bf16 node
    inputs."""
    regions = fused.tc_regions(128, 128, 64)
    assert regions == dict(weights=90112, r1=51200, v=25600)
    assert fused.block_agg_smem(128, 128, 64, 0) == 167424
    assert fused.block_agg_smem(128, 128, 64, 1) == 167424 - 90112
    assert k2.tc_smem_bytes(32, 128, 128, 64, 0) == 204800


@pytest.mark.parametrize("c,f1,f2,last0,last1", [
    (128, 128, 64, 56, 134), (64, 64, 32, 293, 332)])
def test_k2_level_at_the_boundary_n(c, f1, f2, last0, last1):
    for n, want in ((last0, 0), (last0 + 1, 1), (last1, 1),
                    (last1 + 1, None)):
        assert k2.level_for(n, c, f1, f2) == want
    for n, lv in ((last0, 0), (last1, 1)):
        assert k2.tc_smem_bytes(n, c, f1, f2, lv) <= fused.MAX_SMEM
        assert k2.tc_smem_bytes(n + 1, c, f1, f2, lv) > fused.MAX_SMEM
        # the wrapper's rule: the chosen level passes, a forced level
        # 0 beyond its N raises, and so does no level at all
        assert fused.layout_level(None, k2.level_for(n, c, f1, f2), (0, 1),
                              lambda x: k2.tc_smem_bytes(n, c, f1, f2, x)) \
            == lv
    with pytest.raises(ValueError, match="shared memory"):
        fused.layout_level(0, 1, (0, 1),
                       lambda x: k2.tc_smem_bytes(last0 + 1, c, f1, f2, x))
    with pytest.raises(ValueError, match="any level"):
        fused.layout_level(None, None, (0, 1),
                       lambda x: k2.tc_smem_bytes(last1 + 1, c, f1, f2, x))


def test_k3_level_at_the_boundary_c():
    assert fused.block_agg_level(288, 128, 64) == 0
    assert fused.block_agg_level(292, 128, 64) == 1
    assert fused.block_agg_smem(292, 128, 64, 0) > fused.MAX_SMEM
    assert fused.block_agg_level(1600, 128, 64) == 1
    assert fused.block_agg_level(1604, 128, 64) is None


def test_every_shape_the_cuda_core_kernels_took_is_still_taken():
    """For widths that are multiples of 4 (F1 + F2 <= 256), the largest N
    the CUDA-core K2 took and the largest C the CUDA-core K3 took get a
    layout level of the tensor-core kernels."""
    for f1 in range(4, 253, 4):
        for f2 in range(4, 257 - f1, 4):
            for c in (4, 12, 36, 128, 300, 1028):
                n = 2
                while _parent_k2_fits(n + 1, c, f1, f2):
                    n += 1
                if _parent_k2_fits(n, c, f1, f2):
                    assert k2.level_for(n, c, f1, f2) is not None, \
                        (n, c, f1, f2)
            c = 4
            while _parent_k3_fits(c + 4, f1, f2):
                c += 4
            assert fused.block_agg_level(c, f1, f2) is not None, (c, f1, f2)


# ---- K3 at f32: a persistent grid of CUDA-core tiles ------------------------

@pytest.mark.parametrize("rows", [64, 32])
@pytest.mark.parametrize("b,n,grid", [
    (128, 32, 132), (1, 32, 132), (5, 20, 7), (3, 40, 264), (7, 65, 5)])
def test_f32_block_agg_schedule_covers_every_row_once(b, n, grid, rows):
    """The f32 K3 walks 64-pair tiles (levels 0-2: two node rows a tile
    at N = 32, a row in two tiles at N = 65) or 32-pair tiles (level 3),
    with the same contiguous shares."""
    assert rows in (fused.f32_rows(0), fused.f32_rows(3))
    rpg, tiles, groups = fused.block_agg_groups(b, n, rows)
    assert rpg * min(n, rows) <= rows and tiles * rows >= n
    grid = min(grid, groups)
    sched = fused.block_agg_schedule(b, n, grid, rows)
    assert [r for blk in sched for r in blk] == list(range(b * n))
    sizes = [-(-len(blk) // rpg) for blk in sched]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_f32_block_agg_levels_at_the_main_widths():
    """Pinned sums at C = F1 = 128, F2 = 64 (csrc/fused.cu
    block_agg_smem_f32 mirrors them): fa (96 KB) and fb1 (64 KB) staged at
    level 0, fa only at 1, neither at 2 and 3; the level boundaries in C;
    widths whose units take more than one pass go to level 3."""
    f32 = torch.float32
    assert [fused.block_agg_smem_f32(128, 128, 64, lv)
            for lv in (0, 1, 2, 3)] == [216576, 151040, 52736, 52992]
    for c, lv in ((128, 0), (148, 0), (152, 1), (220, 1), (224, 2),
                  (852, 2), (856, 3), (1420, 3), (1424, None)):
        assert fused.block_agg_level(c, 128, 64, f32) == lv, c
    assert fused.f32_one_pass(20, 12) and fused.f32_one_pass(64, 32)
    assert not fused.f32_one_pass(128, 128)
    assert fused.block_agg_level(128, 128, 128, f32) == 3
    assert fused.block_agg_level(128, 128, 64) == 0   # bf16 unchanged


def test_every_shape_the_f32_k3_took_is_still_taken():
    """For widths that are multiples of 4 (F1 + F2 <= 256), the largest C
    the one-block-per-row f32 K3 took gets a level of the persistent
    one."""
    for f1 in range(4, 253, 4):
        for f2 in range(4, 257 - f1, 4):
            c = 4
            while _parent_k3_fits(c + 4, f1, f2):
                c += 4
            assert fused.block_agg_level(c, f1, f2, torch.float32) \
                is not None, (c, f1, f2)
