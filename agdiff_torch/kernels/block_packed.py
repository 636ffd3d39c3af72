"""K2, one interaction block's filter MLPs and aggregation on packed
pairs, for Hopper (port of agdiff_tpu/ops/pallas/block_packed.py; engine
'pk').

`packed_block_aggregate` replaces `_packed_block_kernel`
(block_packed.py:53, entered through `packed_block_aggregate` :109). For
each pair p = (i, j) of the bucket's upper triangle (ops/pairs.py
`triu_pairs`; the JAX kernel asserts P = N(N-1)/2, :123):
    t_p = filter(e_p) we_p          filter as in kernels/fused.py K3
    agg[i] += t_p x_j,  agg[j] += t_p x_i
for (we1, x1, conv1) and (we2, x2, conv2). The products take operands of
e's dtype with an f32 accumulator; the node inputs arrive already at that
dtype (`node_input(c, h).astype(cd)`, agdiff_tpu/models/fast_forward.py:
558-562) and are taken as f32; each message t_p x stays f32, unrounded
(unlike K1, whose messages round to bf16). `approx` swaps the softplus
for ops/approx.py's polynomial ('pk-approx').

The plain twin runs for CPU tensors; CUDA tensors launch csrc/
block_packed.cu (built at first use) or raise: a dtype other than f32 or
bf16, a tight pair list, a shape the pair list does not fit, a bucket
whose node inputs and sums do not fit shared memory (f32 `smem_bytes`:
above N = 104 at H = 128; bf16 `level_for`: above N = 134). At bf16 the
filter MLPs run on the tensor cores with the packed filter weights
(kernels/fused.py `prepared_filter`) staged in shared memory
(layout level 0, to N = 56 at H = 128) or read from L2 (level 1);
`packed_block_launch` forces a level for tests. The kernel sums each
node's messages in increasing pair order, so its result reproduces bit
for bit at either level. `launches` counts the kernel launches per
variant, `last_launch` holds each variant's last level and grid.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from agdiff_torch.kernels import fused, hold
from agdiff_torch.ops import approx as ax
from agdiff_torch.ops.pairs import PairList, gather_nodes, scatter_nodes

# kernel launches per variant ('packed_block[_approx]:<f32|bf16>')
launches: Counter = Counter()
# the last launch of each variant: its layout level and grid (blocks)
last_launch: Dict[str, dict] = {}


def variant(dtype: torch.dtype, approx: bool) -> str:
    return fused.variant(f"packed_block{'_approx' if approx else ''}",
                         dtype)


def smem_bytes(n: int, c: int, f1: int, f2: int) -> int:
    """Shared memory of one f32 block (csrc/block_packed.cu
    packed_block_smem_f32): the pair tile's operands and filter values,
    and the node inputs and sums of the graph, all f32."""
    fw = f1 + f2
    tile = 32
    return 4 * (c * (tile + 4) + fw * (tile + 4) + tile * (fw + 4)
                + 2 * n * fw + 4 * tile)


def tc_smem_bytes(n: int, c: int, f1: int, f2: int, level: int) -> int:
    """Shared memory of one bf16 block (csrc/block_packed.cu
    packed_block_smem_tc): the staged weights (level 0 only), the
    tensor-core tile (kernels/fused.py tc_regions), the tile's distance
    weights and endpoints, and the graph's node sums (f32) and node inputs
    (bf16)."""
    r = fused.tc_regions(c, f1, f2)
    return ((r["weights"] if level == 0 else 0) + r["r1"] + r["v"]
            + 4 * fused.TC_ROWS * 4 + n * (f1 + f2) * (4 + 2))


def level_for(n: int, c: int, f1: int, f2: int) -> Optional[int]:
    """The layout level of the bf16 K2 for a bucket of N: the lowest that
    fits in shared memory (at C = F1 = 128, F2 = 64: 0 to N = 56, 1 to
    N = 134), None if none does."""
    fits = [lv for lv in (0, 1)
            if tc_smem_bytes(n, c, f1, f2, lv) <= fused.MAX_SMEM]
    return fits[0] if fits else None


def packed_block_aggregate_plain(e_packed, we1, we2, x1, x2, conv1, conv2,
                                 pairs: PairList, *, approx: bool = False):
    """Plain PyTorch version of K2: (agg1 (B, N, F1), agg2 (B, N, F2))
    f32."""
    sp = ax.softplus if approx else F.softplus
    out = []
    for we, conv, x in ((we1, conv1, x1), (we2, conv2, x2)):
        t = fused.filter_mlp(e_packed, conv, sp) * we[..., None]
        xf = x.float()
        agg = torch.zeros(xf.shape, dtype=torch.float32, device=xf.device)
        scatter_nodes(agg, pairs.iu, t * gather_nodes(xf, pairs.ju))
        out.append(scatter_nodes(agg, pairs.ju, t * gather_nodes(xf,
                                                                 pairs.iu)))
    return tuple(out)


def packed_block_aggregate(e_packed, we1, we2, x1, x2, conv1, conv2,
                           pairs: PairList, *, approx: bool = False):
    """K2. e_packed (B, P, C) f32 or bf16 over the triu pair set `pairs`;
    we1/we2 (B, P) f32; x1 (B, N, F1) and x2 (B, N, F2) at e's dtype; conv
    dicts as models/fast_forward.fold_eval_params makes them. Returns
    (agg1, agg2) f32."""
    if e_packed.device.type == "cpu":
        return packed_block_aggregate_plain(e_packed, we1, we2, x1, x2,
                                            conv1, conv2, pairs,
                                            approx=approx)
    return packed_block_launch(e_packed, we1, we2, x1, x2, conv1, conv2,
                               pairs, approx=approx)


def packed_block_launch(e_packed, we1, we2, x1, x2, conv1, conv2,
                        pairs: PairList, *, approx: bool = False,
                        level: Optional[int] = None):
    """K2's CUDA kernel on CUDA tensors (packed_block_aggregate's
    arguments). `level` forces a layout level of the bf16 kernel (tests
    and chip_smoke.py; `level_for` picks it otherwise); the f32 kernel has
    level 0 only."""
    dev = e_packed.device
    if dev.type != "cuda":
        raise ValueError(f"packed_block_aggregate: unsupported device {dev}")
    cd = e_packed.dtype
    if cd not in fused.DTYPES:
        raise TypeError(f"e_packed dtype {cd}: the kernel takes f32 or bf16")
    b, p, c = e_packed.shape
    n = x1.shape[1]
    f1, f2 = conv1["fb"][0].shape[1], conv2["fb"][0].shape[1]
    if pairs.tight or not pairs.shared or p != n * (n - 1) // 2 \
            or pairs.num_pairs != p or pairs.num_nodes != n:
        raise ValueError(f"the kernel takes the shared triu pair set of N={n} "
                         f"(N(N-1)/2 pairs), got P={p}, a "
                         f"{'tight' if pairs.tight else 'triu'} list of "
                         f"{pairs.num_pairs}")
    if c % 4 or f1 % 4 or f2 % 4 or f1 + f2 > fused.MAX_FILTER_WIDTH:
        raise ValueError(f"kernel needs C, F1, F2 % 4 == 0 and F1 + F2 <= "
                         f"{fused.MAX_FILTER_WIDTH} (C={c}, F1={f1}, "
                         f"F2={f2})")
    bf = cd == torch.bfloat16
    if bf:
        lv = fused.layout_level(level, level_for(n, c, f1, f2), (0, 1),
                            lambda x: tc_smem_bytes(n, c, f1, f2, x))
    else:
        lv = fused.layout_level(level, 0, (0,),
                            lambda x: smem_bytes(n, c, f1, f2))
    fused.check("e_packed", e_packed, (b, p, c), cd, dev,
                align=8 if bf else 0)
    fused.check("we1", we1, (b, p), torch.float32, dev)
    fused.check("we2", we2, (b, p), torch.float32, dev)
    fused.check("x1", x1, (b, n, f1), cd, dev)
    fused.check("x2", x2, (b, n, f2), cd, dev)
    fused.check("iu", pairs.iu, (p,), torch.int64, dev)
    fused.check("ju", pairs.ju, (p,), torch.int64, dev)
    wts, packed = fused.prepared_filter(conv1, conv2, c, cd, dev)
    out1 = torch.empty((b, n, f1), dtype=torch.float32, device=dev)
    out2 = torch.empty((b, n, f2), dtype=torch.float32, device=dev)
    lib = _lib()
    ptrs = [e_packed, we1, we2, x1, x2, pairs.iu, pairs.ju]
    hold(*wts, packed)
    err = lib.packed_block_launch(
        int(bf), int(approx), *[t.data_ptr() for t in ptrs],
        fused._ptr_array(wts), None if packed is None else packed.data_ptr(),
        out1.data_ptr(), out2.data_ptr(), b, n, p, c, f1, f2, lv,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("packed_block kernel launch failed: "
                           + lib.packed_block_error_string(err).decode())
    name = variant(cd, approx)
    launches[name] += 1
    last_launch[name] = dict(level=lv, grid=b)
    return out1, out2


def _lib():
    from agdiff_torch.kernels import build

    lib = build.load("block_packed")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.packed_block_launch.argtypes = (
            [i, i] + [p] * 7 + [ctypes.POINTER(ctypes.c_void_p), p, p, p]
            + [i] * 7 + [p])
        lib.packed_block_launch.restype = i
        lib.packed_block_error_string.argtypes = [i]
        lib.packed_block_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
