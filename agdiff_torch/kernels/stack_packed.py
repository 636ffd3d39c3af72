"""K1, the whole-stack packed-pair forward, for Hopper: modes 'schnet',
'gin' and 'full', each exact or '-approx', over the triu pair set of a
bucket or a molecule's tight pair list.

Replaces the TPU kernel `_stack_kernel` (agdiff_tpu/ops/pallas/
stack_packed.py:104, entered through `packed_stack_forward` :273). After
the edge encoder, one launch runs the eval forward of
DualEncoderEpsNetwork on a pair list (ops/pairs.py): the NB SchNet
interaction blocks (two filter MLPs per pair, endpoint aggregation, node
tail), then in modes 'gin' and 'full' the NL GIN layers, then in mode
'full' both pair-score heads. 'schnet' returns h (B, N, H) f32, 'gin'
(h, hl), 'full' the two (B, P) packed score planes. The heads' activation
is the config's mlp_act, relu or gelu (`head_activation`). `approx` swaps
the softplus and sigmoid, and the gelu of gelu heads, for ops/approx.py's
polynomial and rational forms.
A tight list's pad slots have zero distance weights and local mask and
no incidence entry, so they add nothing to any node; their scores are
finite and never mirrored.

Design (csrc/stack_packed.cu). One cluster of R CTAs per graph, 512
threads each, in one launch of B clusters. `ranks_for` picks R, the
largest power of two with B * R <= the card's SMs, at most 8 (the
portable cluster size): B=48 -> 2, B=32 -> 4, B=8 or 16 -> 8, B=128 -> 1,
so a Drugs-sized chunk, whose CTAs each fill an SM, no longer leaves most
of the card idle. Each rank takes a contiguous share of the pair tiles
(`rank_tiles`); after each SchNet block's and GIN layer's pair loop the
ranks add their partial node sums in rank order, so every rank holds the
same bits and runs the same node tail; the heads split the slots and need
no exchange. The node states h, hl and the node temporaries live in
shared memory or, in part or in whole, in a per-CTA scratch in global
memory that this wrapper allocates: `layout` picks the smallest level
that leaves shared memory for the staged weights (at H = 128 everything
shared to N = 32, the temporaries in scratch to N = 80, all node regions
in scratch above).
e_packed and the distance-weight planes stream in tiles of 32 pairs; the
weights come from global memory (L2-resident across CTAs) and are staged
in shared memory before each product. Matrix products are bf16 `wmma`
16x16x16 fragments with f32 accumulators, on rows padded by 16 bytes
against bank conflicts; products narrower than 16 (the attention output,
the SE gate, the last score layer) are FMA loops. Aggregation is a
per-node sum over the node's incidence list (staged in shared memory
where it fits) in increasing pair order: no atomics, results reproduce
bit for bit, at every level. The SchNet and GIN loops stop at the last
valid pair; the heads score every slot. Two launches at one R give the
same bits; another R adds the partial sums in another order.

Bound, from the code at B=128, N=32 (P=496), H=128, NB=6, NL=4: per graph
the filter MLPs are 2*P*(128*192 + 128*128 + 64*64) = 44.7 MFLOP per
block (268 MFLOP for six), the score heads 2*2*P*(2*128*128 + 128*64) =
81 MFLOP, the node side ~43 MFLOP: ~390 MFLOP per graph, ~50 GFLOP per
launch, ~51 us at the H100's 989 TFLOP/s bf16 dense. The bytes (e_packed
twice at 16 MB each if untied, the f32 planes ~3 MB, h0/hl0 4 MB, outputs
0.5 MB, weights ~1 MB) are ~25-40 MB, ~10 us at 3.35 TB/s: the launch is
compute-bound, in every mode. chip_smoke.py computes both bounds from
each run's shapes. What this kernel leaves on the table (it runs some 30x
above that bound, PERF.md): no `wgmma` (the legacy mma.sync path through
wmma runs well below Hopper's peak), no TMA, five block-wide barriers per
32-pair tile with warps idle behind the slowest (in the triu order one
node holds most of a tile's pairs, so its aggregation is a long serial
chain, though splitting it across lanes bought nothing, PERF.md), the
node tail repeated on every rank, and node temporaries in L2 from N = 48,
where every pair tile's per-node sums are read and written through L2
(the aggregation is 0.25 of a CTA's cycles at N = 64, PERF.md).

The rounding matches the TPU kernel (stack_packed.py:144-146, 209, 238,
262): every product takes bf16 operands with an f32 accumulator; endpoint
rows are bf16-rounded copies of x, hl and h; per-pair messages t*x_j and
the GIN messages are rounded to bf16 before they are summed; h and hl are
carried in f32; the last score layer is an f32 sum against the (bf16-cast)
w3. The plain version below does the same, so on the card the kernel and
the plain version differ only by summation order and by the last bits of
the kernel's fast exp/log (`__expf`, `__logf`); where such a difference
flips a bf16 rounding, later layers carry it on (chip_smoke.py states the
tolerance).
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from agdiff_torch.kernels.fused import MAX_SMEM, check as _check
from agdiff_torch.nn.common import activation_by_name
from agdiff_torch.ops import approx as ax
from agdiff_torch.ops.pairs import PairList, gather_nodes, scatter_nodes

TILE_P = 32          # pairs per tile (csrc/stack_packed.cu TP)
MAX_RANKS = 8        # the portable thread-block cluster size
MODES = ("schnet", "gin", "full")
LN2 = math.log(2.0)

# kernel launches per variant (`variant`); plain-version calls do not count
launches: Counter = Counter()
# the last launch's cluster size R (CTAs per graph)
last_launch: Dict[str, int] = {}


def variant(mode: str, approx: bool, tight: bool, gelu: bool = False) -> str:
    """Name of a launch variant:
    'stack_<mode>[_gelu][_approx]:<triu|tight>' (gelu heads in mode 'full'
    only: the other modes stop before the heads)."""
    return (f"stack_{mode}{'_gelu' if gelu else ''}"
            f"{'_approx' if approx else ''}:{'tight' if tight else 'triu'}")


def head_activation(name: str, approx: bool = False):
    """The score heads' activation, as the JAX engines choose it
    (agdiff_tpu/models/fast_forward.py:325-345, tight_forward.py:218-238):
    relu, or gelu in jax.nn.gelu's tanh form, or under '-approx' the gelu
    of ops/approx.py (its rational tanh). The kernel's GELU and APPROX
    template parameters make the same choice."""
    if name == "gelu" and approx:
        return ax.gelu
    return activation_by_name(name)


@dataclass
class StackParams:
    """Folded weights the whole-stack forward reads (kernels in (in, out)
    layout, as models/fast_forward.fold_eval_params makes them).

    blocks: per interaction block, dict(convs=[conv1, conv2], act_beta,
      lin, att0, att1, se0, se1); each conv dict(fa, beta, fb, lin1, lin2)
      with (kernel, bias) pairs. gin_layers: dict(l0, l1). grad_global /
      grad_local: (w1, b1, w2, b2, w3, b3) score heads.
    """

    blocks: List[dict]
    gin_layers: List[dict]
    grad_global: Tuple[torch.Tensor, ...]
    grad_local: Tuple[torch.Tensor, ...]
    act: str = "relu"
    _packed: Dict[torch.device, tuple] = field(default_factory=dict,
                                               repr=False)

    @property
    def hidden(self) -> int:
        return self.blocks[0]["lin"][0].shape[1]


def _leaky(x):
    return torch.where(x > 0, x, 0.2 * x)


def packed_stack_forward_plain(e_packed, we, h0, params: StackParams,
                               e_packed_local, local_mask_p, hl0,
                               pairs: PairList, *, mode: str = "full",
                               approx: bool = False):
    """Plain PyTorch version of K1.

    e_packed / e_packed_local (B, P, C) at the compute dtype (bf16 or f32);
    we (2*NB, B, P) f32 planes [blk0 conv1, blk0 conv2, ...], zero at pad
    slots; h0 / hl0 (B, N, H) f32; local_mask_p (B, P), zero at pad slots;
    pairs an ops.pairs.PairList. Mode 'schnet' needs no local inputs and
    returns h (B, N, H) f32; 'gin' returns (h, hl); 'full' the packed score
    planes (global, local), each (B, P) f32.
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    cd = e_packed.dtype
    sp, sig = (ax.softplus, ax.sigmoid) if approx else (F.softplus,
                                                       torch.sigmoid)

    def ssp(x, beta):
        return sp(beta * x) - LN2

    def rnd(x):
        return x.to(cd).float()

    def dot(x, w):
        return rnd(x) @ rnd(w)

    act = head_activation(params.act, approx)
    iu, ju = pairs.iu, pairs.ju
    b, n = h0.shape[:2]

    def aggregate(m_i, m_j):
        # m_i lands on endpoint i, m_j on endpoint j; each message is
        # rounded to the compute dtype before the sum, as in the TPU kernel
        # (pad slots carry zero messages)
        out = torch.zeros((b, n, m_i.shape[-1]), device=m_i.device)
        scatter_nodes(out, iu, rnd(m_i))
        return scatter_nodes(out, ju, rnd(m_j))

    def filt(conv, we_k):
        v = ssp(dot(e_packed, conv["fa"][0]) + conv["fa"][1], conv["beta"])
        return (dot(v, conv["fb"][0]) + conv["fb"][1]) * we_k[..., None]

    h = h0.float()
    for k, blk in enumerate(params.blocks):
        c1, c2 = blk["convs"]
        x = torch.cat([_leaky(dot(h, c["lin1"][0]) + c["lin1"][1])
                       for c in (c1, c2)], dim=-1)
        t = torch.cat([filt(c1, we[2 * k]), filt(c2, we[2 * k + 1])], -1)
        xb = rnd(x)
        a = aggregate(t * gather_nodes(xb, ju), t * gather_nodes(xb, iu))
        f1 = c1["fb"][0].shape[1]
        p1 = dot(a[..., :f1], c1["lin2"][0]) + c1["lin2"][1]
        p2 = dot(a[..., f1:], c2["lin2"][0]) + c2["lin2"][1]
        comb = ssp(torch.cat([p1, p2], -1), blk["act_beta"])
        comb = dot(comb, blk["lin"][0]) + blk["lin"][1]
        gate = torch.relu(dot(comb, blk["att0"][0]) + blk["att0"][1])
        gate = sig(dot(gate, blk["att1"][0]) + blk["att1"][1])
        out = comb * gate
        out = out * sig(dot(torch.relu(dot(out, blk["se0"])), blk["se1"]))
        h = h + out
    if mode == "schnet":
        return h

    el = e_packed_local.float()
    lm = local_mask_p.float()[..., None]
    hl = hl0.float()
    for li, layer in enumerate(params.gin_layers):
        hb = rnd(hl)
        agg = aggregate(torch.relu((gather_nodes(hb, ju) + el) * lm),
                        torch.relu((gather_nodes(hb, iu) + el) * lm))
        out = torch.relu(dot(hl + agg, layer["l0"][0]) + layer["l0"][1])
        out = dot(out, layer["l1"][0]) + layer["l1"][1]
        if li < len(params.gin_layers) - 1:
            out = torch.relu(out)
        hl = out + hl
    if mode == "gin":
        return h, hl

    def scores(hx, e, p6):
        w1, b1, w2, b2, w3, b3 = p6
        c = e.shape[-1]
        hb = rnd(hx)
        prod = gather_nodes(hb, iu) * gather_nodes(hb, ju)
        x = act(dot(prod, w1[:c]) + dot(e, w1[c:]) + b1)
        y = act(dot(x, w2) + b2)
        return (y * w3[:, 0].float()).sum(-1) + b3.float()[0]

    return (scores(h, e_packed, params.grad_global),
            scores(hl, e_packed_local, params.grad_local))


def packed_stack_forward(e_packed, we, h0, params: StackParams,
                         e_packed_local, local_mask_p, hl0, pairs, *,
                         mode: str = "full", approx: bool = False,
                         level: Optional[int] = None,
                         ranks: Optional[int] = None):
    """K1. CPU tensors run the plain version; CUDA tensors launch the
    hand-written kernel (bf16 e_packed, shared pair lists) or raise.
    `level` forces a layout level of the kernel (`layout`; every level
    gives the same bits) and `ranks` the CTAs per graph (`ranks_for`
    chooses otherwise; a cluster size the card cannot launch raises), for
    tests and measurement."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if e_packed.device.type == "cpu":
        return packed_stack_forward_plain(
            e_packed, we, h0, params, e_packed_local, local_mask_p, hl0,
            pairs, mode=mode, approx=approx)
    return _launch(e_packed, we, h0, params, e_packed_local, local_mask_p,
                   hl0, pairs, mode, approx, level, ranks)


# ---- the CUDA kernel -------------------------------------------------------

def _pack(params: StackParams, device) -> tuple:
    """Flat bf16 and f32 weight buffers plus the int32 offset table the
    kernel indexes. The table lists the bf16 entries of every block, the
    f32 entries of every block, the bf16 GIN and head entries, then the f32
    GIN and head entries, each in the enum order of csrc/stack_packed.cu;
    every entry starts at a multiple of 16 elements
    (32-byte aligned, as wmma fragment loads need)."""
    cached = params._packed.get(device)
    if cached is not None:
        return cached
    bf_parts, f_parts, bf_offs, f_offs = [], [], [], []

    def put(parts, offs, t, dtype):
        t = t.detach().reshape(-1).to(device=device, dtype=dtype)
        start = sum(p.numel() for p in parts)
        offs.append(start)
        pad = (-t.numel()) % 16
        parts.append(torch.cat([t, t.new_zeros(pad)]) if pad else t)

    def wb(t):
        put(bf_parts, bf_offs, t, torch.bfloat16)

    def wf(t):
        put(f_parts, f_offs, t, torch.float32)

    for blk in params.blocks:
        c1, c2 = blk["convs"]
        wb(torch.cat([c1["fa"][0], c2["fa"][0]], 1))       # W_FA (C, 1.5H)
        wb(c1["fb"][0])                                    # W_FB1
        wb(c2["fb"][0])                                    # W_FB2
        wb(torch.cat([c1["lin1"][0], c2["lin1"][0]], 1))   # W_L1 (H, 1.5H)
        wb(c1["lin2"][0])                                  # W_L2A
        wb(c2["lin2"][0])                                  # W_L2B
        wb(blk["lin"][0])                                  # W_LIN
        wb(blk["att0"][0])                                 # W_ATT0
        wb(blk["att1"][0])                                 # W_ATT1
        wb(blk["se0"])                                     # W_SE0
        wb(blk["se1"])                                     # W_SE1
    for blk in params.blocks:
        c1, c2 = blk["convs"]
        wf(torch.cat([c1["fa"][1], c2["fa"][1]]))          # F_BA
        wf(torch.cat([c1["fb"][1], c2["fb"][1]]))          # F_BB
        wf(torch.cat([c1["lin1"][1], c2["lin1"][1]]))      # F_L1B
        wf(c1["lin2"][1])                                  # F_L2AB
        wf(c2["lin2"][1])                                  # F_L2BB
        wf(blk["lin"][1])                                  # F_LINB
        wf(blk["att0"][1])                                 # F_ATT0B
        wf(blk["att1"][1])                                 # F_ATT1B
        wf(torch.stack([torch.as_tensor(c1["beta"]).float().reshape(()),
                        torch.as_tensor(c2["beta"]).float().reshape(()),
                        torch.as_tensor(blk["act_beta"]).float()
                        .reshape(())]))                    # F_BETA
    for layer in params.gin_layers:
        wb(layer["l0"][0])                                 # G_L0
        wb(layer["l1"][0])                                 # G_L1
    for layer in params.gin_layers:
        wf(layer["l0"][1])                                 # GF_B0
        wf(layer["l1"][1])                                 # GF_B1
    c = params.hidden
    for p6 in (params.grad_global, params.grad_local):
        wb(p6[0][:c])                                      # S_W1H
        wb(p6[0][c:])                                      # S_W1E
        wb(p6[2])                                          # S_W2
    for p6 in (params.grad_global, params.grad_local):
        wf(p6[1])                                          # SF_B1
        wf(p6[3])                                          # SF_B2
        wf(p6[4])                                          # SF_W3
        wf(p6[5])                                          # SF_B3
    offs = torch.tensor(bf_offs[:11 * len(params.blocks)]
                        + f_offs[:9 * len(params.blocks)]
                        + bf_offs[11 * len(params.blocks):]
                        + f_offs[9 * len(params.blocks):],
                        dtype=torch.int32, device=device)
    packed = (torch.cat(bf_parts).contiguous(), torch.cat(f_parts)
              .contiguous(), offs)
    params._packed[device] = packed
    return packed


def region_bytes(n: int, h: int) -> Tuple[int, int, int, int]:
    """Bytes of one CTA's groups of regions (csrc/stack_packed.cu Regions,
    with its padded strides): node states h and hl, the small per-node
    arrays, the node temporaries NF and XB, and the pair tile."""
    np_ = -(-n // 16) * 16
    fw = h + h // 2
    ldf, ldx, lde, ldv, ldb = 2 * h + 4, 2 * h + 8, h + 8, fw + 4, fw + 8
    states = 2 * np_ * h * 4
    small = (4 * np_ + 1) * 4
    temps = np_ * ldf * 4 + np_ * ldx * 2
    tile = TILE_P * lde * 2 + TILE_P * ldv * 4 + TILE_P * ldb * 2 \
        + 2 * TILE_P * 4
    return states, small, temps, tile


def smem_bytes(n: int, h: int, level: int = 0) -> int:
    """Shared memory one CTA needs at a layout level (without the weight
    region the kernel adds when that fits too): level 0 keeps every
    node-sized region in shared memory, level 1 moves the node temporaries
    to global scratch, level 2 the node states and small arrays too."""
    states, small, temps, tile = region_bytes(n, h)
    return (tile + (temps if level < 1 else 0)
            + (states + small if level < 2 else 0))


def scratch_bytes(n: int, h: int, level: int) -> int:
    """Global scratch per graph at a layout level, in 256-byte units."""
    states, small, temps, _ = region_bytes(n, h)
    raw = (temps if level >= 1 else 0) + (states + small if level >= 2
                                          else 0)
    return -(-raw // 256) * 256


def weight_region_bytes(h: int) -> int:
    """The staged weights' region (csrc/stack_packed.cu): the largest set
    staged at once, at padded row strides."""
    fw = h + h // 2
    filters = h * (fw + 8) + h * (h + 8) + (h // 2) * (h // 2 + 8)
    head = 2 * h * (h + 8) + h * (h // 2 + 8)
    return 2 * max(filters, head, 2 * h * (h + 8))


def layout(n: int, h: int) -> Tuple[int, int, int]:
    """(level, shared bytes, scratch bytes per graph): the smallest level
    at which the staged weights fit beside the shared regions, else the
    smallest at which the shared regions fit. Staging the weights
    outweighs keeping node regions in shared memory (PERF.md: at B=48,
    N=64 level 1 with staged weights beats level 0 without); every level
    gives the same bits."""
    fits = [lv for lv in (0, 1, 2) if smem_bytes(n, h, lv) <= MAX_SMEM]
    if not fits:
        raise ValueError(f"H={h} needs {smem_bytes(n, h, 2)} bytes of "
                         f"shared memory even with every node region in "
                         f"global memory")
    staged = [lv for lv in fits if -(-smem_bytes(n, h, lv) // 128) * 128
              + weight_region_bytes(h) <= MAX_SMEM]
    level = (staged or fits)[0]
    return level, smem_bytes(n, h, level), scratch_bytes(n, h, level)


def ranks_for(b: int, sm_count: int) -> int:
    """CTAs per graph (one cluster each): the largest power of two R with
    b * R <= sm_count, at most MAX_RANKS; 1 when b graphs fill the card."""
    r = 1
    while r < MAX_RANKS and b * r * 2 <= sm_count:
        r *= 2
    return r


def rank_tiles(num_tiles: int, ranks: int) -> List[Tuple[int, int]]:
    """Each rank's contiguous share [t0, t1) of `num_tiles` pair tiles
    (csrc/stack_packed.cu split)."""
    return [(num_tiles * r // ranks, num_tiles * (r + 1) // ranks)
            for r in range(ranks)]


def rank_entries(pairs: PairList, ranks: int) -> List[List[Tuple[int,
                                                                  int]]]:
    """Per rank, per node, the [start, end) of the incidence entries the
    rank sums over the valid pairs' tiles: from the node's first entry at
    or past the rank's first pair (the kernel's ballot scan,
    tile_cursors) to its first entry at or past the pair after the
    rank's last tile."""
    ptr = pairs.inc_ptr.tolist()
    pair = pairs.inc_pair.tolist()
    tiles = rank_tiles(-(-pairs.num_valid // TILE_P), ranks)

    def first_at(n, p):
        q = ptr[n]
        while q < ptr[n + 1] and pair[q] < p:
            q += 1
        return q

    return [[(first_at(n, t0 * TILE_P), first_at(n, t1 * TILE_P))
             for n in range(pairs.num_nodes)] for t0, t1 in tiles]


def _lib():
    from agdiff_torch.kernels import build

    lib = build.load("stack_packed")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.stack_launch.argtypes = ([i, i, i] + [p] * 16 + [ctypes.c_longlong]
                                     + [i] * 10 + [p])
        lib.stack_launch.restype = i
        lib.stack_error_string.argtypes = [i]
        lib.stack_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(e_packed, we, h0, params, e_packed_local, local_mask_p, hl0,
            pairs: PairList, mode: str, approx: bool, level=None,
            ranks=None):
    dev = e_packed.device
    if dev.type != "cuda":
        raise ValueError(f"packed_stack_forward: unsupported device {dev}")
    if params.act not in ("relu", "gelu"):
        raise ValueError(f"head activation {params.act!r}")
    gelu = mode == "full" and params.act == "gelu"
    b, p, c = e_packed.shape
    n, h = h0.shape[1], h0.shape[2]
    nb, nl = len(params.blocks), len(params.gin_layers)
    if c != h or h % 32:
        raise ValueError(f"kernel needs C == H and H % 32 == 0 (C={c}, "
                         f"H={h})")
    if not pairs.shared or pairs.inc_ptr is None:
        raise ValueError("the kernel takes a shared pair list with "
                         "incidence lists")
    if p != pairs.num_pairs or n != pairs.num_nodes:
        raise ValueError(f"pair list ({pairs.num_pairs}, {pairs.num_nodes}) "
                         f"does not match P={p}, N={n}")
    if level is None:
        level = layout(n, h)[0]
    if smem_bytes(n, h, level) > MAX_SMEM:
        raise ValueError(f"layout level {level} does not fit N={n}, H={h}")
    scratch_per_cta = scratch_bytes(n, h, level)
    if ranks is None:
        ranks = ranks_for(b, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    _check("e_packed", e_packed, (b, p, c), torch.bfloat16, dev)
    _check("we", we, (2 * nb, b, p), torch.float32, dev)
    _check("h0", h0, (b, n, h), torch.float32, dev)
    if mode == "schnet":
        # the kernel reads no local inputs in this mode
        e_packed_local, lm, hl0 = e_packed, we, h0
    else:
        _check("e_packed_local", e_packed_local, (b, p, c), torch.bfloat16,
               dev)
        _check("hl0", hl0, (b, n, h), torch.float32, dev)
        lm = local_mask_p.to(torch.float32).contiguous()
        _check("local_mask_p", lm, (b, p), torch.float32, dev)
    for name in ("iu", "ju"):
        _check(name, getattr(pairs, name), (p,), torch.int64, dev)
    nv = pairs.num_valid
    for name, length in (("inc_ptr", n + 1), ("inc", 2 * nv)):
        _check(name, getattr(pairs, name), (length,), torch.int32, dev)
    wbf, wf, offs = _pack(params, dev)
    if mode == "full":
        out0 = torch.empty((b, p), dtype=torch.float32, device=dev)
        out1 = torch.empty((b, p), dtype=torch.float32, device=dev)
    else:
        out0 = torch.empty((b, n, h), dtype=torch.float32, device=dev)
        out1 = (torch.empty((b, n, h), dtype=torch.float32, device=dev)
                if mode == "gin" else out0)
    scratch = torch.empty((max(b * ranks * scratch_per_cta, 1),),
                          dtype=torch.uint8, device=dev)
    lib = _lib()
    ptrs = [e_packed, e_packed_local, we, h0, hl0, lm, pairs.iu, pairs.ju,
            pairs.inc_ptr, pairs.inc, wbf, wf, offs, out0, out1, scratch]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.stack_launch(MODES.index(mode), int(approx), int(gelu),
                               *[t.data_ptr() for t in ptrs],
                               scratch_per_cta, b, n, p, nv,
                               pairs.inc_shift, h, nb, nl, level, ranks,
                               stream)
    if err != 0:
        raise RuntimeError(f"stack kernel launch failed at ranks={ranks}: "
                           + lib.stack_error_string(err).decode())
    launches[variant(mode, approx, pairs.tight, gelu)] += 1
    last_launch["ranks"] = ranks
    if mode == "full":
        return out0, out1
    return out0 if mode == "schnet" else (out0, out1)
