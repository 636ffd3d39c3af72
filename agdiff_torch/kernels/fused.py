"""K3, K4 and K5, the dense-layout edge consumers of engine 'pallas', for
Hopper (port of agdiff_tpu/ops/pallas/fused.py).

* `interaction_block_aggregate` (K3) replaces `_block_agg_kernel`
  (fused.py:181, entered through `interaction_block_aggregate` :206): both
  CFConv pathways of one interaction block on the dense (B, N, N, C) edge
  features,
      v = ssp(e @ fa + ba),  ssp(x) = softplus(beta x) - ln 2,
      t = v @ fb + bb,
      out[b, i, f] = sum_j t[b, i, j, f] w[b, i, j] h[b, j, f],
  for (w_edge1, h1, conv1) and (w_edge2, h2, conv2). The products take
  operands of e's dtype with an f32 accumulator (v is rounded to it
  before the second product; the weights are cast to it); the rest is f32
  and unrounded. Rows with w = 0 are multiplied, not skipped.
* `pair_score_mlp` (K4) replaces `_pair_score_kernel` (fused.py:82,
  entered through `pair_score_mlp` :106): s[b, i, j] =
  MLP3(concat(h_i h_j, e_ij)), zero off the mask. h_i h_j is taken at h's
  dtype (rounded when bf16); x = act([h_i h_j | e] @ w1 + b1) with an f32
  accumulator, rounded to the weights' dtype; y = act(x @ w2 + b2) in f32;
  s = sum_c y[c] w3[c] + b3 in f32. act is relu or gelu (jax.nn.gelu's
  tanh form, as the TPU kernel's `_act`; K4 has no '-approx' form). The
  weights are taken at h's dtype, as the JAX engine casts them; the
  biases stay f32.
* `gine_aggregate` (K5) replaces `_gine_kernel` (fused.py:142, entered
  through `gine_aggregate` :153): out[b, i] = sum_j mask_ij relu(x_j +
  e_ij), in f32. The JAX engine calls it at f32 only
  (agdiff_tpu/models/fast_forward.py:753-758), and so does this kernel.

Each function has a `*_plain` twin in PyTorch. The wrapper runs the twin
for CPU tensors and launches the CUDA kernel (csrc/fused.cu, built at first
use) for CUDA tensors, or raises for what the kernel does not take: a
dtype, a shape, a device mismatch, an activation other than relu and
gelu. K3 at
bf16 runs on the tensor cores over a persistent grid
(`block_agg_schedule`), with the filter weights packed once per weight
set (`prepared_filter`, `pack_filter_weights`) and staged in shared
memory (layout level 0) or read from L2 (level 1, `block_agg_level`); at
f32 it runs true-f32 register units on CUDA cores over the same kind of
persistent grid (64-pair tiles; 32 at level 3), with fa and fb1 staged
once per block where they fit (levels 0-3), the one-block-per-row form's
bits;
`block_agg_launch` forces a level for tests. K4 walks each graph's
masked pairs only (`pair_score_pairs` mirrors its list; every other cell
is written 0 by the kernel), R blocks a graph; at bf16 on the tensor
cores with w1 and w2 packed once per weight set
(`pack_pair_score_weights`), at f32 on CUDA cores with the
one-block-per-row form's bits; `pair_score_level` and `pair_score_layout`
mirror its shared memory and `pair_score_launch` forces a level or R for
tests. K5 is a
fused elementwise pass plus a reduction, which Triton could express; it is
CUDA C++ here too, so that the port has one build path. `launches` counts
the kernel launches per variant; the plain twins count nothing.

Design, bounds and what these first kernels leave on the table:
csrc/fused.cu.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from agdiff_torch.kernels import hold
from agdiff_torch.nn.common import activation_by_name

LN2 = math.log(2.0)
DTYPES = (torch.float32, torch.bfloat16)
MAX_FILTER_WIDTH = 256   # F1 + F2: one thread a column (csrc/fused.cu)
MAX_SMEM = 232448        # bytes of shared memory a block may use on Hopper
TC_ROWS = 64             # pairs of a tensor-core tile (csrc/filter_mlp.cuh)
TC_PAD = 8               # bf16 elements padding each operand row
FT_ROWS = 32             # pairs of a CUDA-core tile (K3 at f32)

# kernel launches per variant ('<kernel>:<f32|bf16>'); plain calls do not
# count
launches: Counter = Counter()
# the last launch of each variant: its layout level and grid (blocks)
last_launch: Dict[str, dict] = {}


def variant(kernel: str, dtype: torch.dtype) -> str:
    """Name of a launch variant, e.g. 'block_agg:bf16' (K4's gelu form:
    'pair_score_gelu:<dtype>')."""
    return f"{kernel}:{'bf16' if dtype == torch.bfloat16 else 'f32'}"


def _dot(x, w, cd):
    """x @ w on operands rounded to cd, with an f32 result (an f32
    accumulator; a bf16 product is exact in f32)."""
    return x.to(cd).float() @ w.to(cd).float()


def filter_mlp(e, conv, softplus=F.softplus):
    """A CFConv filter MLP at e's dtype: (ssp(e @ fa + ba) rounded) @ fb +
    bb, in f32 (fused.py:192-196, block_packed.py:66-72)."""
    cd = e.dtype
    v = _dot(e, conv["fa"][0], cd) + conv["fa"][1]
    v = softplus(conv["beta"] * v) - LN2
    return _dot(v, conv["fb"][0], cd) + conv["fb"][1]


# ---- the tensor-core layout (csrc/filter_mlp.cuh) ---------------------------

def pad16(x: int) -> int:
    return -(-x // 16) * 16


def tc_regions(c: int, f1: int, f2: int) -> Dict[str, int]:
    """Bytes of a tensor-core filter tile's shared-memory regions
    (filter_mlp.cuh tc_weight_elems, tc_r1_bytes, tc_v_bytes): the packed
    weights, E | Tt (the edge tile, then the second layers' f32 output)
    and V (the first layers' bf16 output), for widths padded to 16."""
    cp, f1p, f2p = pad16(c), pad16(f1), pad16(f2)
    fwp = f1p + f2p
    return dict(weights=2 * (cp * fwp + f1p * f1p + f2p * f2p),
                r1=max(TC_ROWS * (cp + TC_PAD) * 2, TC_ROWS * (fwp + 8) * 4),
                v=TC_ROWS * (fwp + TC_PAD) * 2)


def block_agg_smem(c: int, f1: int, f2: int, level: int) -> int:
    """Shared memory of one bf16 K3 block (csrc/fused.cu
    block_agg_smem_tc): level 0 stages the packed weights, level 1 reads
    them from global memory; both hold the tile and its distance
    weights."""
    r = tc_regions(c, f1, f2)
    return ((r["weights"] if level == 0 else 0) + r["r1"] + r["v"]
            + 2 * TC_ROWS * 4)


F32_ROWS = 64            # pairs of the f32 K3's one-pass tiles (levels 0-2)


def f32_rows(level: int) -> int:
    """Pairs a tile of the f32 K3 at a layout level (csrc/fused.cu)."""
    return F32_ROWS if level < 3 else FT_ROWS


def f32_one_pass(f1: int, f2: int) -> bool:
    """Whether the f32 K3's units of each layer fit one pass of the 16
    warps at 64-pair tiles (levels 0-2): a warp takes 32 rows and 24
    columns of layer 1, 16 of fb1, 8 of fb2; two warps down a tile."""
    f6 = -(-(f1 + f2) // 6) * 6
    return max(2 * -(-f6 // 24), 2 * -(-f1 // 16), 2 * -(-f2 // 8)) <= 16


def block_agg_smem_f32(c: int, f1: int, f2: int, level: int) -> int:
    """Shared memory of one f32 K3 block (csrc/fused.cu
    block_agg_smem_f32): fa = [fa1 | fa2] at F1 + F2 rounded up to 6
    columns (levels 0, 1), fb1 (level 0), then E, V and Tt in one region
    (levels 0-2, 64-pair tiles) or E | Tt and V (level 3, 32 pairs), and
    the tile's distance weights."""
    fw, r = f1 + f2, f32_rows(level)
    f6 = -(-fw // 6) * 6
    region = max(c * (r + 4), r * (fw + 4), fw * (r + 4) if level < 3 else 0)
    return ((4 * c * f6 if level <= 1 else 0)
            + (4 * f1 * f1 if level == 0 else 0) + 4 * region
            + (4 * fw * (r + 4) if level == 3 else 0) + 4 * 2 * r)


def block_agg_level(c: int, f1: int, f2: int,
                    dtype: torch.dtype = torch.bfloat16) -> Optional[int]:
    """The layout level of K3 at these widths: the lowest that fits in
    shared memory, None if none does. bf16: 0 stages the packed weights
    (to C = 288 at F1 = 128, F2 = 64), 1 reads them from L2. f32: 0 stages
    fa and fb1 (to C = 148), 1 fa (to C = 220), 2 neither (to C = 852),
    each on 64-pair tiles where the widths take one pass of units; 3, on
    32-pair tiles, takes the rest (to C = 1420)."""
    if dtype == torch.float32:
        fits = [lv for lv in (0, 1, 2, 3)
                if block_agg_smem_f32(c, f1, f2, lv) <= MAX_SMEM
                and (lv == 3 or f32_one_pass(f1, f2))]
    else:
        fits = [lv for lv in (0, 1)
                if block_agg_smem(c, f1, f2, lv) <= MAX_SMEM]
    return fits[0] if fits else None


def block_agg_groups(b: int, n: int, rows: int = TC_ROWS) -> tuple:
    """K3's unit of work (csrc/fused.cu block_agg_tc, block_agg_f32) for
    tiles of `rows` pairs (TC_ROWS at bf16, f32_rows at f32): (node rows
    per group, tiles per group, groups). A group is rows // N whole node
    rows in one tile when N <= rows, else one node row in ceil(N / rows)
    tiles."""
    rpg = rows // n if n <= rows else 1
    tiles = 1 if n <= rows else -(-n // rows)
    return rpg, tiles, -(-(b * n) // rpg)


def block_agg_schedule(b: int, n: int, grid: int,
                       rows: int = TC_ROWS) -> List[List[int]]:
    """The node rows (b * N + i) each block of a grid of `grid` sums, in
    its order: block k takes a contiguous share of the groups, the first
    groups % grid blocks one more than the rest."""
    rpg, _, groups = block_agg_groups(b, n, rows)
    per, extra = divmod(groups, grid)
    out = []
    for k in range(grid):
        g0 = k * per + min(k, extra)
        g1 = g0 + per + (k < extra)
        out.append(list(range(g0 * rpg, min(g1 * rpg, b * n))))
    return out


# ---- K4's layout (csrc/fused.cu) ---------------------------------------------

MAX_PAIR_N = 256         # K4 lists cells as 16-bit indices


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def pair_lists_bytes(n: int) -> int:
    """Bytes of one CTA's pair lists (csrc/fused.cu pair_lists_bytes): the
    mask's ballot words and their bases (one each per 32 cells), the
    count, and the masked cells as 16-bit indices."""
    nc = -(-n * n // 32)
    return 2 * _r16(4 * nc) + 16 + _r16(2 * n * n)


def pair_score_smem(c: int, h1: int, h2: int, dtype: torch.dtype,
                    level: int) -> int:
    """Shared memory of a K4 block without h and the lists (csrc/fused.cu
    pair_score_smem). bf16: the packed w1 and w2 (level 0), the tile
    [h_i h_j | e] (TC_ROWS x (2Cp + TC_PAD)), the first layer's output
    (TC_ROWS x (H1p + TC_PAD)) and the head's partial sums. f32: w1
    (levels 0, 1), w2 (level 0), the tile k-major (2C x (FT_ROWS + 4),
    later the second layer's output) and the first layer's output."""
    if dtype == torch.bfloat16:
        cp, h1p, h2p = pad16(c), pad16(h1), pad16(h2)
        return ((2 * (2 * cp * h1p + h1p * h2p) if level == 0 else 0)
                + 2 * TC_ROWS * (2 * cp + TC_PAD)
                + 2 * TC_ROWS * (h1p + TC_PAD) + 4 * TC_ROWS * (h2p // 16))
    ld = FT_ROWS + 4
    return ((4 * 2 * c * h1 if level <= 1 else 0)
            + (4 * h1 * h2 if level == 0 else 0)
            + 4 * max(2 * c * ld, FT_ROWS * (h2 + 4)) + 4 * h1 * ld)


def pair_score_h_bytes(n: int, c: int, dtype: torch.dtype) -> int:
    """The graph's h, staged at bf16 (f32 reads it through L1)."""
    return _r16(2 * n * c) if dtype == torch.bfloat16 else 0


@functools.lru_cache(maxsize=None)
def pair_score_level(n: int, c: int, h1: int, h2: int,
                     dtype: torch.dtype) -> Optional[int]:
    """K4's layout level: the lowest whose regions and h fit in shared
    memory, None if none does. At H1 = 128, H2 = 64, N = 32: bf16 0 stages
    the packed weights (to C = 224), 1 reads them from L2; f32 0 stages w1
    and w2 (to C = 136), 1 w1 (to C = 160), 2 neither."""
    levels = (0, 1) if dtype == torch.bfloat16 else (0, 1, 2)
    fits = [lv for lv in levels
            if pair_score_smem(c, h1, h2, dtype, lv)
            + pair_score_h_bytes(n, c, dtype) <= MAX_SMEM]
    return fits[0] if fits else None


@functools.lru_cache(maxsize=None)
def pair_score_layout(n: int, c: int, h1: int, h2: int, dtype: torch.dtype,
                      level: Optional[int] = None) -> tuple:
    """(level, shared bytes, lists in shared memory) of a K4 launch at
    `level` (default pair_score_level's): the lists go to the wrapper's
    scratch where they do not fit beside the regions."""
    lv = pair_score_level(n, c, h1, h2, dtype) if level is None else level
    if lv is None:
        return None, None, False
    shared = pair_score_smem(c, h1, h2, dtype, lv) + pair_score_h_bytes(
        n, c, dtype)
    if shared + pair_lists_bytes(n) <= MAX_SMEM:
        return lv, shared + pair_lists_bytes(n), True
    return lv, shared, False


def pair_score_pairs(mask: torch.Tensor) -> List[torch.Tensor]:
    """Each graph's list as K4 builds it: the masked cells i * N + j of
    its (N, N) plane in increasing order (the ballot words' order, each
    word's set bits from the lowest)."""
    return [torch.nonzero(m.reshape(-1)).reshape(-1) for m in mask]


def pack_pair_score_weights(w1: torch.Tensor,
                            w2: torch.Tensor) -> torch.Tensor:
    """K4's w1 and w2 as its tensor-core tiles read them: w1's rows [0, C)
    (the products' side) at rows [0, Cp) and its rows [C, 2C) at [Cp, Cp +
    C) of a (2Cp, H1p) matrix, then w2 (H1p, H2p), each pack_matrix'ed, in
    one flat buffer."""
    c2, h1 = w1.shape
    c, cp = c2 // 2, pad16(c2 // 2)
    w = w1.new_zeros(2 * cp, h1)
    w[:c] = w1[:c]
    w[cp:cp + c] = w1[c:]
    return torch.cat([pack_matrix(w, 2 * cp, pad16(h1)),
                      pack_matrix(w2, pad16(h1), pad16(w2.shape[1]))
                      ]).contiguous()


def _fragment_order() -> torch.Tensor:
    """Where each of the 256 values of a packed 16 x 16 block comes from,
    as k * 16 + n: lane (g, t) = (lane // 4, lane % 4) holds (k, n) =
    (2t, g), (2t + 1, g), (2t + 8, g), (2t + 9, g), then the same at n + 8
    (the B fragments of mma.m16n8k16 for both n8 halves)."""
    lane = torch.arange(32)[:, None]
    v = torch.arange(8)[None, :]
    g, t = lane // 4, lane % 4
    k = 2 * t + (v & 1) + 8 * ((v >> 1) & 1)
    return (k * 16 + g + 8 * (v >> 2)).reshape(-1)


def pack_matrix(w: torch.Tensor, kp: int, np_: int) -> torch.Tensor:
    """w (K, Nn) zero-padded to (kp, np_), flat in packed order: strips of
    16 columns, each its kp / 16 blocks of 16 rows, each block in
    fragment order."""
    k, nn = w.shape
    wp = w.new_zeros(kp, np_)
    wp[:k, :nn] = w
    blocks = wp.reshape(kp // 16, 16, np_ // 16, 16).permute(2, 0, 1, 3)
    order = _fragment_order().to(w.device)
    return blocks.reshape(np_ // 16, kp // 16, 256)[..., order].reshape(-1)


def unpack_matrix(flat: torch.Tensor, k: int, nn: int) -> torch.Tensor:
    """The inverse of pack_matrix: the (k, nn) matrix a packed strip set
    holds."""
    kp, np_ = pad16(k), pad16(nn)
    blocks = torch.empty((np_ // 16, kp // 16, 256), dtype=flat.dtype,
                         device=flat.device)
    blocks[..., _fragment_order().to(flat.device)] = flat.reshape(
        np_ // 16, kp // 16, 256)
    wp = blocks.reshape(np_ // 16, kp // 16, 16, 16).permute(1, 2, 0, 3)
    return wp.reshape(kp, np_)[:k, :nn]


def pack_filter_weights(fa1, fa2, fb1, fb2) -> torch.Tensor:
    """The four filter matrices as the tensor-core tile reads them: fa =
    [fa1 | fa2] with fa1 in columns [0, F1p) and fa2 in [F1p, F1p + F2p)
    (C x FWp), then fb1 (F1p x F1p), then fb2 (F2p x F2p), each
    pack_matrix'ed, in one flat buffer of fa1's dtype."""
    c, f1 = fa1.shape
    f2 = fa2.shape[1]
    cp, f1p, f2p = pad16(c), pad16(f1), pad16(f2)
    fa = fa1.new_zeros(c, f1p + f2p)
    fa[:, :f1] = fa1
    fa[:, f1p:f1p + f2] = fa2
    return torch.cat([pack_matrix(fa, cp, f1p + f2p),
                      pack_matrix(fb1, f1p, f1p),
                      pack_matrix(fb2, f2p, f2p)])


def unpack_filter_weights(packed, c: int, f1: int, f2: int) -> tuple:
    """(fa1, fa2, fb1, fb2) from a pack_filter_weights buffer."""
    cp, f1p, f2p = pad16(c), pad16(f1), pad16(f2)
    n_fa, n_fb1 = cp * (f1p + f2p), f1p * f1p
    fa = unpack_matrix(packed[:n_fa], c, f1p + f2p)
    fb1 = unpack_matrix(packed[n_fa:n_fa + n_fb1], f1, f1)
    fb2 = unpack_matrix(packed[n_fa + n_fb1:], f2, f2)
    return fa[:, :f1], fa[:, f1p:f1p + f2], fb1, fb2


# prepared weights by the identity of their source tensors (held here, so
# an id is not reused while its entry lives), checked against their
# versions
_PREPARED: Dict[tuple, tuple] = {}


def _prepared(srcs, key, make):
    """make(), once per set of source tensors `srcs` and `key` while none
    of them changes in place (the forwards keep their weights), so that a
    launch does not redo its casts, checks and packing."""
    key = (tuple(id(t) for t in srcs), key)
    versions = tuple(getattr(t, "_version", None) for t in srcs)
    hit = _PREPARED.get(key)
    if hit is not None and hit[1] == versions:
        return hit[2]
    value = make()
    if None not in versions:
        if len(_PREPARED) >= 64:
            _PREPARED.pop(next(iter(_PREPARED)))
        _PREPARED[key] = (srcs, versions, value)
    return value


def prepared_filter(conv1, conv2, c, cd, device) -> tuple:
    """(filter_weights(...), pack_filter_weights of the four matrices at
    bf16, or None at f32) for two convs, made once per weight set and
    dtype."""
    srcs = tuple(t for conv in (conv1, conv2)
                 for t in (*conv["fa"], *conv["fb"], conv["beta"]))

    def make():
        wts = filter_weights(conv1, conv2, c, cd, device)
        return wts, (pack_filter_weights(*wts[:4]).contiguous()
                     if cd == torch.bfloat16 else None)
    return _prepared(srcs, ("filter", cd, str(device), c), make)


def prepared_head(ws, c, cd, device) -> tuple:
    """(K4's six weights as the kernel reads them, w1 and w2 packed for the
    tensor cores at bf16 or None at f32), made once per weight set and
    dtype. They do not depend on the activation, which the launch passes
    on its own, so the relu and gelu launches share them."""
    w1, b1, w2, b2, w3, b3 = ws
    h1, h2 = w1.shape[1], w2.shape[1]

    def make():
        wts = [weight(w1, (2 * c, h1), cd, device),
               weight(b1, (h1,), None, device),
               weight(w2, (h1, h2), cd, device),
               weight(b2, (h2,), None, device),
               weight(w3, (h2, 1), cd, device),
               weight(b3, (1,), None, device)]
        return wts, (pack_pair_score_weights(wts[0], wts[2])
                     if cd == torch.bfloat16 else None)
    return _prepared(tuple(ws), ("head", cd, str(device), c), make)


# ---- plain versions ----------------------------------------------------------

def interaction_block_aggregate_plain(edge_attr, w_edge1, w_edge2, h1, h2,
                                      conv1, conv2):
    """Plain PyTorch version of K3: (agg1 (B, N, F1), agg2 (B, N, F2))
    f32."""
    out = []
    for w_edge, conv, h in ((w_edge1, conv1, h1), (w_edge2, conv2, h2)):
        t = filter_mlp(edge_attr, conv) * w_edge[..., None]
        out.append((t * h[:, None].float()).sum(2))
    return tuple(out)


def pair_score_rows(prod, edge_attr, w1, b1, w2, b2, w3, b3,
                    activation: str = "relu"):
    """K4's MLP on rows of pairs: prod (..., C) the products h_i h_j and
    edge_attr (..., C) e_ij at the operand dtype; returns (...) f32. The
    plain version's arithmetic, row by row."""
    cd = prod.dtype
    act = activation_by_name(activation)
    c = prod.shape[-1]
    w1, w2, w3 = w1.to(cd), w2.to(cd), w3.to(cd)
    x = act(_dot(prod, w1[:c], cd) + _dot(edge_attr, w1[c:], cd) + b1)
    y = act(_dot(x, w2, cd) + b2)
    return (y * w3[:, 0].float()).sum(-1) + b3.float()[0]


def pair_score_mlp_plain(h, edge_attr, edge_mask, w1, b1, w2, b2, w3, b3,
                         activation: str = "relu"):
    """Plain PyTorch version of K4: (B, N, N) f32."""
    prod = h[:, :, None, :] * h[:, None, :, :]
    s = pair_score_rows(prod, edge_attr, w1, b1, w2, b2, w3, b3, activation)
    return torch.where(edge_mask, s, torch.zeros((), device=s.device))


def gine_aggregate_plain(x, edge_attr, local_mask):
    """Plain PyTorch version of K5: (B, N, C) f32."""
    msg = torch.relu(x[:, None].float() + edge_attr.float())
    return (msg * local_mask[..., None].float()).sum(2)


# ---- wrappers ----------------------------------------------------------------

def interaction_block_aggregate(edge_attr, w_edge1, w_edge2, h1, h2, conv1,
                                conv2):
    """K3. edge_attr (B, N, N, C) f32 or bf16; w_edge1/2 (B, N, N) f32;
    h1 (B, N, F1), h2 (B, N, F2) f32; conv dicts with fa, beta, fb as
    models/fast_forward.fold_eval_params makes them. Returns (agg1, agg2)
    f32."""
    if edge_attr.device.type == "cpu":
        return interaction_block_aggregate_plain(
            edge_attr, w_edge1, w_edge2, h1, h2, conv1, conv2)
    return block_agg_launch(edge_attr, w_edge1, w_edge2, h1, h2, conv1,
                            conv2)


def block_agg_launch(edge_attr, w_edge1, w_edge2, h1, h2, conv1, conv2, *,
                     level: Optional[int] = None):
    """K3's CUDA kernel on CUDA tensors (interaction_block_aggregate's
    arguments). `level` forces a layout level (tests and chip_smoke.py;
    `block_agg_level` picks it otherwise): 0 or 1 at bf16, 0 to 3 at
    f32 (0-2 only where `f32_one_pass`), each giving the same bits."""
    dev, cd = _device_and_dtype(edge_attr, "edge_attr")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (edge_attr, w_edge1, w_edge2, h1, h2) + tuple(
                t for conv in (conv1, conv2)
                for t in (*conv["fa"], *conv["fb"], conv["beta"]))):
        raise RuntimeError("K3 has no backward: a gradient through "
                           "interaction_block_aggregate takes "
                           "interaction_block_aggregate_plain")
    b, n, n2, c = edge_attr.shape
    f1, f2 = conv1["fb"][0].shape[1], conv2["fb"][0].shape[1]
    if n2 != n:
        raise ValueError(f"edge_attr shape {tuple(edge_attr.shape)} is not "
                         f"(B, N, N, C)")
    if c % 4 or f1 % 4 or f2 % 4 or f1 + f2 > MAX_FILTER_WIDTH:
        raise ValueError(f"kernel needs C, F1, F2 % 4 == 0 and F1 + F2 <= "
                         f"{MAX_FILTER_WIDTH} (C={c}, F1={f1}, F2={f2})")
    bf = cd == torch.bfloat16
    check("edge_attr", edge_attr, (b, n, n, c), cd, dev, align=8 if bf else 16)
    check("w_edge1", w_edge1, (b, n, n), torch.float32, dev)
    check("w_edge2", w_edge2, (b, n, n), torch.float32, dev)
    check("h1", h1, (b, n, f1), torch.float32, dev)
    check("h2", h2, (b, n, f2), torch.float32, dev)
    lv = layout_level(level, block_agg_level(c, f1, f2, cd),
                      (0, 1) if bf else (0, 1, 2, 3),
                      lambda x: (block_agg_smem if bf else block_agg_smem_f32)(
                          c, f1, f2, x))
    wts, packed = prepared_filter(conv1, conv2, c, cd, dev)
    out1 = torch.empty((b, n, f1), dtype=torch.float32, device=dev)
    out2 = torch.empty((b, n, f2), dtype=torch.float32, device=dev)
    hold(*wts, packed)
    lib = _lib()
    grid = ctypes.c_int(0)
    err = lib.block_agg_launch(
        int(bf), *_ptrs(edge_attr, w_edge1, w_edge2, h1, h2),
        _ptr_array(wts), None if packed is None else packed.data_ptr(),
        *_ptrs(out1, out2), b, n, c, f1, f2, lv, ctypes.byref(grid),
        _stream(dev))
    _raise_on(lib, err, "block_agg")
    name = variant("block_agg", cd)
    launches[name] += 1
    last_launch[name] = dict(level=lv, grid=grid.value)
    return out1, out2


def layout_level(level, chosen, levels, smem) -> int:
    """The layout level to launch: `level` when forced, else `chosen`;
    raises when it is not one of `levels` or its shared memory (`smem`,
    a function of the level) is over MAX_SMEM."""
    lv = chosen if level is None else level
    if lv not in levels:
        raise ValueError(f"layout level {lv} not in {levels}: the shape does "
                         f"not fit in shared memory at any level")
    if smem(lv) > MAX_SMEM:
        raise ValueError(f"layout level {lv} needs {smem(lv)} bytes of "
                         f"shared memory, more than {MAX_SMEM}")
    return lv


def pair_score_mlp(h, edge_attr, edge_mask, w1, b1, w2, b2, w3, b3,
                   activation: str = "relu"):
    """K4. h (B, N, C) and edge_attr (B, N, N, C) at one dtype (f32 or
    bf16); edge_mask (B, N, N) bool; w1 (2C, H1) (rows [0, C) take h_i h_j,
    [C, 2C) e_ij), w2 (H1, H2), w3 (H2, 1), taken at h's dtype; biases
    f32. Returns (B, N, N) f32."""
    if h.device.type == "cpu":
        return pair_score_mlp_plain(h, edge_attr, edge_mask, w1, b1, w2, b2,
                                    w3, b3, activation)
    return pair_score_launch(h, edge_attr, edge_mask, w1, b1, w2, b2, w3, b3,
                             activation=activation)


def pair_score_launch(h, edge_attr, edge_mask, w1, b1, w2, b2, w3, b3, *,
                      activation: str = "relu",
                      level: Optional[int] = None,
                      ranks: Optional[int] = None):
    """K4's CUDA kernel on CUDA tensors (pair_score_mlp's arguments; relu
    or gelu activations). `level` forces a layout level (0 or 1 at bf16,
    0 to 2 at f32; pair_score_level picks it otherwise) and `ranks` the
    CTAs per graph (the card's occupancy picks it otherwise): tests and
    chip_smoke.py; every level and R give the same bits."""
    if activation not in ("relu", "gelu"):
        raise ValueError(f"K4 takes relu or gelu, not {activation!r}")
    gelu = activation == "gelu"
    dev, cd = _device_and_dtype(h, "h")
    b, n, c = h.shape
    h1, h2 = w1.shape[1], w2.shape[1]
    if c % 4 or h1 % 4 or h2 % 4 or n > MAX_PAIR_N:
        raise ValueError(f"kernel needs C, H1, H2 % 4 == 0 and N <= "
                         f"{MAX_PAIR_N} (C={c}, H1={h1}, H2={h2}, N={n})")
    bf = cd == torch.bfloat16
    check("h", h, (b, n, c), cd, dev, align=8 if bf else 16)
    check("edge_attr", edge_attr, (b, n, n, c), cd, dev,
          align=8 if bf else 16)
    check("edge_mask", edge_mask, (b, n, n), torch.bool, dev)
    if ranks is not None and ranks < 1:
        raise ValueError(f"ranks={ranks}: at least one CTA a graph")
    wts, packed = prepared_head((w1, b1, w2, b2, w3, b3), c, cd, dev)
    lv = layout_level(level, pair_score_level(n, c, h1, h2, cd),
                      (0, 1) if bf else (0, 1, 2),
                      lambda x: pair_score_smem(c, h1, h2, cd, x)
                      + pair_score_h_bytes(n, c, cd))
    in_smem = pair_score_layout(n, c, h1, h2, cd, lv)[2]
    out = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    lib = _lib()
    got = ctypes.c_int(0)
    args = [int(bf), int(gelu), *_ptrs(h, edge_attr, edge_mask),
            _ptr_array(wts),
            None if packed is None else packed.data_ptr(), out.data_ptr()]
    scratch = None
    if not in_smem:
        if ranks is None:   # plan: the R the launch takes, for the scratch
            err = lib.pair_score_launch(*args, None, b, n, c, h1, h2, lv, 0,
                                        0, 0, ctypes.byref(got), _stream(dev))
            _raise_on(lib, err, "pair_score")
            ranks = got.value
        scratch = torch.empty(b * ranks * pair_lists_bytes(n),
                              dtype=torch.uint8, device=dev)
    hold(*wts, packed)
    err = lib.pair_score_launch(
        *args, None if scratch is None else scratch.data_ptr(), b, n, c, h1,
        h2, lv, int(in_smem), ranks or 0, 1, ctypes.byref(got), _stream(dev))
    _raise_on(lib, err, "pair_score")
    name = variant("pair_score_gelu" if gelu else "pair_score", cd)
    launches[name] += 1
    last_launch[name] = dict(level=lv, ranks=got.value, grid=b * got.value,
                             lists="smem" if in_smem else "scratch")
    return out


def gine_aggregate(x, edge_attr, local_mask):
    """K5. x (B, N, C) and edge_attr (B, N, N, C) f32; local_mask (B, N, N)
    bool. Returns (B, N, C) f32."""
    if x.device.type == "cpu":
        return gine_aggregate_plain(x, edge_attr, local_mask)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"gine_aggregate: unsupported device {dev}")
    b, n, c = x.shape
    if c % 4:
        raise ValueError(f"kernel needs C % 4 == 0 (C={c})")
    # f32 only, as the JAX engine calls it (fast_forward.py:753-758)
    check("x", x, (b, n, c), torch.float32, dev, align=16)
    check("edge_attr", edge_attr, (b, n, n, c), torch.float32, dev,
          align=16)
    check("local_mask", local_mask, (b, n, n), torch.bool, dev)
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.gine_launch(*_ptrs(x, edge_attr, local_mask, out), b, n, c,
                          _stream(dev))
    _raise_on(lib, err, "gine")
    launches[variant("gine", torch.float32)] += 1
    return out


# ---- launch helpers (also used by kernels/block_packed.py) -------------------

def check(name, t, shape, dtype, device, align: int = 0):
    """Raise unless t lies on `device` with this dtype and shape,
    contiguous (and its data `align`-byte aligned)."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(f"{name} is not {align}-byte aligned")


def weight(t, shape, dtype, device):
    """A weight, bias or scalar as the kernel reads it: on `device`,
    contiguous, at `dtype` (None: f32). A no-op for a weight prepared so
    (models/fast_forward.py); raises for another shape or device, or for
    data that is not 16-byte aligned (vector loads)."""
    t = torch.as_tensor(t)
    if t.device != device:
        raise ValueError(f"a weight lies on {t.device}, expected {device}")
    if t.numel() != math.prod(shape) or (t.dim() and tuple(t.shape) !=
                                         tuple(shape)):
        raise ValueError(f"weight shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    t = t.detach().to(torch.float32 if dtype is None else dtype).contiguous()
    if t.data_ptr() % 16:
        raise ValueError("a weight is not 16-byte aligned")
    return t


def filter_weights(conv1, conv2, c, cd, device):
    """fa1, fa2, fb1, fb2 at cd, then ba1, ba2, bb1, bb2, beta1, beta2 in
    f32: the order of the kernels' weight tables (csrc/filter_mlp.cuh
    FilterW)."""
    f1, f2 = conv1["fb"][0].shape[1], conv2["fb"][0].shape[1]
    return [weight(conv1["fa"][0], (c, f1), cd, device),
            weight(conv2["fa"][0], (c, f2), cd, device),
            weight(conv1["fb"][0], (f1, f1), cd, device),
            weight(conv2["fb"][0], (f2, f2), cd, device),
            weight(conv1["fa"][1], (f1,), None, device),
            weight(conv2["fa"][1], (f2,), None, device),
            weight(conv1["fb"][1], (f1,), None, device),
            weight(conv2["fb"][1], (f2,), None, device),
            weight(conv1["beta"], (1,), None, device),
            weight(conv2["beta"], (1,), None, device)]


def _device_and_dtype(t, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} dtype {t.dtype}: the kernel takes f32 or "
                        f"bf16")
    return t.device, t.dtype


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _ptr_array(ts):
    return (ctypes.c_void_p * len(ts))(*_ptrs(*ts))


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.error_string(err).decode())


def _lib():
    from agdiff_torch.kernels import build

    lib = build.load("fused")
    if not getattr(lib, "_typed", False):
        p, i, pp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
            ctypes.c_void_p)
        lib.block_agg_launch.argtypes = [i] + [p] * 5 + [pp, p, p, p] \
            + [i] * 6 + [ctypes.POINTER(i), p]
        lib.pair_score_launch.argtypes = [i, i, p, p, p, pp, p, p, p] \
            + [i] * 9 + [ctypes.POINTER(i), p]
        lib.gine_launch.argtypes = [p] * 4 + [i] * 3 + [p]
        for fn in (lib.block_agg_launch, lib.pair_score_launch,
                   lib.gine_launch):
            fn.restype = i
        lib.error_string = lib.fused_error_string
        lib.error_string.argtypes = [i]
        lib.error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
