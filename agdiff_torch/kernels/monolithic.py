"""K6, the whole eval forward in one launch, for Hopper (port of
agdiff_tpu/ops/pallas/monolithic.py).

Replaces the TPU kernel `_mono_kernel` (monolithic.py:240, entered through
`build_monolithic_forward` :387). One launch runs, per graph and over the
bucket's N(N-1)/2 unordered pairs (ops/pairs.py triu_pairs): the edge
encoder, the cutoff envelope and the per-conv distance weights, the NB
SchNet interaction blocks, the NL GIN layers and both pair-score heads,
and writes the two packed (B, P) score planes, masked by the working
graph (global) and the bond graph (local). models/mono_forward.py builds
its inputs and mirrors its planes to dense.

`prepare_weights` is the port of `_prepare_weights` (:69-196): BatchNorm
folded, the bond halves of the encoder's two concat layers folded into
128-row type tables `emb @ w[H:] + b` (bias inside), per-conv and
per-block weights stacked, matmul operands at the compute dtype cd and
the rest f32, under JAX's keys.

Rounding points, which are K6's and not K1's (`mono_forward_plain`
follows them, and the kernel is held to it):
  * kfe and the type tables are cd values; `d * kfe + bfe` is f32; a type
    table row is gathered by bond type (a one-hot product with a table of
    cd values is that row exactly);
  * each product takes cd operands with an f32 accumulator; the encoder
    rounds x and y to cd before the next product; e stays f32 (e32) for
    the GIN messages and is rounded to cd (ecd) for the filters and heads;
  * CFConv: wedge = sigmoid(sum relu(d dw1k + dw1b) dw2k + dw2b) * env in
    f32; the filter times wedge is rounded to cd (wp); the message wp * x_j
    is a cd product, rounded to cd, before the f32 sum; conv2 runs at F/2;
  * the envelope (cosine with smooth_conv, else Gaussian) is multiplied by
    (d <= cutoff)(d >= 0) em in both cases;
  * the attention gate's second layer is an f32 dot of f32 values;
  * GIN: relu(x_j + e32) lm with x_j the cd-rounded hl, rounded to cd,
    then the f32 sum; hl + agg and the two-layer MLP;
  * heads: h_i h_j a cd product, rounded; act(two f32 dots + b1) rounded;
    act(. @ w2 + b2) in f32; the last layer an f32 sum against f32 w3;
  * h0 and hl0 come rounded to cd and are carried in f32.
At f32 every product is a true f32 product: the kernel multiplies on CUDA
cores, not in TF32.

The TPU's `tile`, its 128-lane pair padding and its block-diagonal EI/EJ
selector products only fit the MXU and VMEM and are not carried over: the
kernel walks explicit endpoint and incidence lists, as K1 does.

Design (csrc/mono.cu): one CTA per graph, 512 threads, K1's layout of
node regions (shared memory, or a per-graph global scratch by `layout`
levels) and its fixed-order per-node aggregation, bitwise repeatable.
Each CTA first lists its graph's working pairs (em or lm nonzero; lm is a
subset of em, ops/graph.py working_graph) in pair order and filters the
incidence lists to them; every pair phase walks only those, and both
planes are written 0 off them. Off the list every message is +-0 and
both heads are multiplied by 0, so this gives the bits of the whole
triangle (`mono_forward_plain` over a graph's working pairs alone equals
it over the triangle; tests/test_torch_port_mono.py). Phase 1 encodes the
working pairs tile by tile into an f32 per-graph scratch e32 ((B, P, H),
row r of a graph its r-th working pair, allocated once and reused by
`MonoParams.buffer`; 32.5 MB at B=128, N=32, H=128, inside the 50 MB L2),
which the later phases read back, rounding on load where cd is bf16. At
bf16 the SchNet filter MLPs run on K2's and K3's tensor-core tile (64
pairs, the filter weights packed per block by `_pack`) and the other
products are bf16 `wmma` fragments with f32 accumulators; at f32 every
product is f32 fused multiply-adds on CUDA cores.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from agdiff_torch.kernels import hold
from agdiff_torch.kernels.fused import TC_ROWS, pack_filter_weights, tc_regions
from agdiff_torch.kernels.fused import check as _check
from agdiff_torch.nn.common import activation_by_name, gelu
from agdiff_torch.nn.schnet import envelope
from agdiff_torch.ops.pairs import PairList, gather_nodes, scatter_nodes

LN2 = math.log(2.0)
TYPE_ROWS = 128      # rows of the bond-type tables (types are < 100)
TILE_P = 32          # pairs per tile (csrc/mono.cu TP)
MAX_SMEM = 232448    # bytes of shared memory a block may use on Hopper
DTYPES = (torch.float32, torch.bfloat16)

# kernel launches per variant ('mono[_gelu]:bf16' / 'mono[_gelu]:f32');
# plain calls do not count
launches: Counter = Counter()


def variant(dtype: torch.dtype, act: str = "relu") -> str:
    """Name of a launch variant; gelu heads add '_gelu'."""
    return (f"mono{'_gelu' if act == 'gelu' else ''}:"
            f"{'bf16' if dtype == torch.bfloat16 else 'f32'}")


# matmul operands (cd); every other entry is f32 (monolithic.py:188-192)
MATMUL_KEYS = frozenset(
    {"kfe", "w0a", "w1", "w2a", "w3", "table0", "table2", "bk_link",
     "bk_att0k", "bk_se0", "bk_se1", "gn_l0k", "gn_l1k", "sc_g1a", "sc_g1e",
     "sc_g2k"}
    | {f"c{ci}_{k}" for ci in (1, 2) for k in ("fa", "fb", "l1k", "l2k")})


def prepare_weights(config, model, compute_dtype) -> Dict[str, torch.Tensor]:
    """The port of `_prepare_weights` (monolithic.py:69-196) on a port
    module: the same keys, shapes and dtypes (schnet_emb and gin_emb
    included), on the module's device."""
    from agdiff_torch.models.fast_forward import fold_eval_params

    if not config.tie_edge_encoders:
        raise NotImplementedError(
            "the monolithic kernel supports tied edge encoders (the "
            "reference behavior); use the module path for untied")
    H = config.hidden_dim
    folded = fold_eval_params(model)
    ee = folded["ee"]

    def lin(layer):
        return layer.weight.detach().t(), layer.bias.detach()

    emb = ee.bond_emb.weight.detach()
    k_fe, b_fe = lin(ee.feature_expansion)
    w0, b0 = lin(ee.edge_feature_mlp_0)
    w1, b1 = lin(ee.edge_feature_mlp_1)
    w2, b2 = lin(ee.combination_mlp_0)
    w3, b3 = lin(ee.combination_mlp_1)

    def pad_rows(t):
        return torch.cat([t, t.new_zeros(TYPE_ROWS - t.shape[0], t.shape[1])])

    w = dict(kfe=k_fe[0:1], bfe=b_fe[None],
             table0=pad_rows(emb @ w0[H:] + b0), w0a=w0[:H], w1=w1,
             b1=b1[None], table2=pad_rows(emb @ w2[H:] + b2), w2a=w2[:H],
             w3=w3, b3=b3[None])
    blocks = folded["blocks"]
    for ci in (1, 2):
        convs = [blk["convs"][ci - 1] for blk in blocks]
        w.update({
            f"c{ci}_dw1k": torch.stack([c["dw1"][0][0] for c in convs]),
            f"c{ci}_dw1b": torch.stack([c["dw1"][1] for c in convs]),
            f"c{ci}_dw2k": torch.stack([c["dw2"][0][:, 0] for c in convs]),
            f"c{ci}_dw2b": torch.stack([c["dw2"][1] for c in convs]),
            f"c{ci}_beta": torch.stack([c["beta"].reshape(1)
                                        for c in convs]),
            f"c{ci}_fa": torch.stack([c["fa"][0] for c in convs]),
            f"c{ci}_ba": torch.stack([c["fa"][1] for c in convs]),
            f"c{ci}_fb": torch.stack([c["fb"][0] for c in convs]),
            f"c{ci}_bb": torch.stack([c["fb"][1] for c in convs]),
            f"c{ci}_l1k": torch.stack([c["lin1"][0] for c in convs]),
            f"c{ci}_l1b": torch.stack([c["lin1"][1] for c in convs]),
            f"c{ci}_l2k": torch.stack([c["lin2"][0] for c in convs]),
            f"c{ci}_l2b": torch.stack([c["lin2"][1] for c in convs]),
        })
    w.update(
        bk_act_beta=torch.stack([b["act_beta"].reshape(1) for b in blocks]),
        bk_link=torch.stack([b["lin"][0] for b in blocks]),
        bk_linb=torch.stack([b["lin"][1] for b in blocks]),
        bk_att0k=torch.stack([b["att0"][0] for b in blocks]),
        bk_att0b=torch.stack([b["att0"][1] for b in blocks]),
        bk_att1k=torch.stack([b["att1"][0][:, 0] for b in blocks]),
        bk_att1b=torch.stack([b["att1"][1] for b in blocks]),
        bk_se0=torch.stack([b["se0"] for b in blocks]),
        bk_se1=torch.stack([b["se1"] for b in blocks]),
        schnet_emb=folded["schnet_emb"])
    gin = folded["gin_layers"]
    w.update(gn_l0k=torch.stack([g["l0"][0] for g in gin]),
             gn_l0b=torch.stack([g["l0"][1] for g in gin]),
             gn_l1k=torch.stack([g["l1"][0] for g in gin]),
             gn_l1b=torch.stack([g["l1"][1] for g in gin]),
             gin_emb=folded["gin_emb"])
    heads = (folded["grad_global"], folded["grad_local"])
    w.update(sc_g1a=torch.stack([p[0][:H] for p in heads]),
             sc_g1e=torch.stack([p[0][H:] for p in heads]),
             sc_g1b=torch.stack([p[1] for p in heads]),
             sc_g2k=torch.stack([p[2] for p in heads]),
             sc_g2b=torch.stack([p[3] for p in heads]),
             sc_g3k=torch.stack([p[4][:, 0] for p in heads]),
             sc_g3b=torch.stack([p[5] for p in heads]))
    return {k: v.detach().to(compute_dtype if k in MATMUL_KEYS
                             else torch.float32).contiguous()
            for k, v in w.items()}


@dataclass
class MonoParams:
    """What K6 reads: `prepare_weights`' dict without the two embeddings,
    and the configuration it bakes in."""

    w: Dict[str, torch.Tensor]
    cutoff: float
    smooth: bool
    act: str = "relu"
    _packed: Dict[torch.device, tuple] = field(default_factory=dict,
                                               repr=False)
    # K6's scratch buffers by (device, name), allocated once and reused by
    # later launches on the same stream (grown when too small)
    _scratch: Dict[tuple, torch.Tensor] = field(default_factory=dict,
                                                repr=False)

    def buffer(self, device, name: str, nbytes: int) -> torch.Tensor:
        key = (str(device), name)
        buf = self._scratch.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty((max(nbytes, 256),), dtype=torch.uint8,
                              device=device)
            self._scratch[key] = buf
        return buf

    @property
    def cd(self) -> torch.dtype:
        return self.w["w1"].dtype

    @property
    def hidden(self) -> int:
        return self.w["w1"].shape[0]

    @property
    def num_convs(self) -> int:
        return self.w["bk_link"].shape[0]

    @property
    def num_local(self) -> int:
        return self.w["gn_l0k"].shape[0]


def _ssp(x, beta):
    return F.softplus(beta * x) - LN2


def encode_plain(dp, tp, w):
    """K6's edge encoder (monolithic.py:274-288): e32 (B, P, H) f32 from
    the pair distances and bond types."""
    cd = w["w1"].dtype

    def dot(x, k):
        return x.to(cd).float() @ k.float()

    def table(key):
        ok = (tp >= 0) & (tp < TYPE_ROWS)
        rows = w[key].float()[tp.clamp(0, TYPE_ROWS - 1).long()]
        return rows * ok[..., None]

    expanded = gelu(dp[..., None] * w["kfe"].float()[0] + w["bfe"][0])
    x = gelu(dot(expanded, w["w0a"]) + table("table0"))
    x = dot(x, w["w1"]) + w["b1"]
    y = gelu(dot(x, w["w2a"]) + table("table2"))
    return dot(y, w["w3"]) + w["b3"]


def mono_forward_plain(dp, em, lm, tp, h0, hl0, params: MonoParams,
                       pairs: PairList):
    """Plain PyTorch version of K6.

    dp, em, lm (B, P) f32: pair distances, the working-graph and the bond
    masks; tp (B, P) int bond types; h0, hl0 (B, N, H) f32, already
    rounded to cd; pairs the bucket's triu list. Returns the packed score
    planes (global, local), each (B, P) f32."""
    w, cd = params.w, params.cd
    act = activation_by_name(params.act)
    iu, ju = pairs.iu, pairs.ju
    b, n = h0.shape[:2]

    def rnd(x):
        return x.to(cd).float()

    def dot(x, k):
        return rnd(x) @ k.float()

    d3 = dp[..., None]
    e = encode_plain(dp, tp, w)                          # e32
    ecd = rnd(e)
    env = envelope(dp, params.cutoff, params.smooth) * em

    def aggregate(m_i, m_j):
        out = torch.zeros((b, n, m_i.shape[-1]), device=m_i.device)
        scatter_nodes(out, iu, m_i)
        return scatter_nodes(out, ju, m_j)

    def cf_pathway(ci, k, hg):
        g = lambda name: w[f"c{ci}_{name}"][k]              # noqa: E731
        xdw = torch.relu(d3 * g("dw1k") + g("dw1b"))
        lw = torch.sigmoid((xdw * g("dw2k")).sum(-1) + g("dw2b")[0])
        wedge = lw * env
        flt = _ssp(dot(ecd, g("fa")) + g("ba"), g("beta")[0])
        flt = dot(flt, g("fb")) + g("bb")
        wp = rnd(flt * wedge[..., None])
        xn = rnd(F.leaky_relu(dot(hg, g("l1k")) + g("l1b"), 0.2))
        acc = aggregate(rnd(wp * gather_nodes(xn, ju)),
                        rnd(wp * gather_nodes(xn, iu)))
        return dot(acc, g("l2k")) + g("l2b")

    hg = h0.float()
    for k in range(params.num_convs):
        comb = _ssp(torch.cat([cf_pathway(1, k, hg), cf_pathway(2, k, hg)],
                              -1), w["bk_act_beta"][k, 0])
        comb = dot(comb, w["bk_link"][k]) + w["bk_linb"][k]
        gate = torch.relu(dot(comb, w["bk_att0k"][k]) + w["bk_att0b"][k])
        gate = torch.sigmoid((gate * w["bk_att1k"][k]).sum(-1, keepdim=True)
                             + w["bk_att1b"][k, 0])
        out = comb * gate
        se = torch.relu(dot(out, w["bk_se0"][k]))
        hg = hg + out * torch.sigmoid(dot(se, w["bk_se1"][k]))

    def scores(node, s, mask):
        hb = rnd(node)
        prod = rnd(gather_nodes(hb, iu) * gather_nodes(hb, ju))
        xs = act(dot(prod, w["sc_g1a"][s]) + dot(ecd, w["sc_g1e"][s])
                 + w["sc_g1b"][s])
        ys = act(dot(xs, w["sc_g2k"][s]) + w["sc_g2b"][s])
        return ((ys * w["sc_g3k"][s]).sum(-1) + w["sc_g3b"][s, 0]) * mask

    lmf = lm[..., None]
    hl = hl0.float()
    for li in range(params.num_local):
        hb = rnd(hl)
        o = hl + aggregate(rnd(torch.relu(gather_nodes(hb, ju) + e) * lmf),
                           rnd(torch.relu(gather_nodes(hb, iu) + e) * lmf))
        o = torch.relu(dot(o, w["gn_l0k"][li]) + w["gn_l0b"][li])
        o = dot(o, w["gn_l1k"][li]) + w["gn_l1b"][li]
        if li < params.num_local - 1:
            o = torch.relu(o)
        hl = o + hl
    return scores(hg, 0, em), scores(hl, 1, lm)


def working_pairs(em, lm) -> list:
    """Each graph's working pairs (em or lm nonzero), in pair order, as
    K6 lists them (csrc/mono.cu phase 0): a list of B int64 tensors."""
    keep = (em != 0) | (lm != 0)
    return [torch.nonzero(k).flatten() for k in keep]


def mono_forward(dp, em, lm, tp, h0, hl0, params: MonoParams,
                 pairs: PairList, *, level: Optional[int] = None):
    """K6. CPU tensors run the plain version; CUDA tensors launch the
    hand-written kernel or raise. `level` forces a layout level (`layout`;
    every level gives the same bits), for measurement."""
    if dp.device.type == "cpu":
        return mono_forward_plain(dp, em, lm, tp, h0, hl0, params, pairs)
    return _launch(dp, em, lm, tp, h0, hl0, params, pairs, level)


# ---- the CUDA kernel -------------------------------------------------------

def region_bytes(n: int, h: int, itemsize: int) -> Tuple[int, int, int, int]:
    """Bytes of one CTA's groups of regions (csrc/mono.cu Regions, with
    its padded strides), for cd values of `itemsize` bytes: node states h
    and hl, the small per-node arrays, the node temporaries NF and XB, and
    the pair tile (at bf16 the larger of the 32-pair tile and the 64-pair
    filter tile, kernels/fused.py tc_regions)."""
    np_ = -(-n // 16) * 16
    fw = h + h // 2
    ldf, ldx, lde, ldv, ldb = 2 * h + 4, 2 * h + 8, h + 8, fw + 4, fw + 8
    states = 2 * np_ * h * 4
    small = (4 * np_ + 1) * 4
    temps = np_ * ldf * 4 + np_ * ldx * itemsize
    tile = (TILE_P * lde * itemsize + TILE_P * ldv * 4
            + TILE_P * ldb * itemsize + 2 * TILE_P * 4)
    if itemsize == 2:
        tc = tc_regions(h, h, h // 2)
        tile = max(tile, tc["r1"] + tc["v"] + 2 * TC_ROWS * 4)
    return states, small, temps, tile


def smem_bytes(n: int, h: int, itemsize: int, level: int = 0) -> int:
    """Shared memory of the regions at a layout level (without the weight
    region): level 0 keeps every node region shared, 1 moves the node
    temporaries to global scratch, 2 the node states and small arrays
    too."""
    states, small, temps, tile = region_bytes(n, h, itemsize)
    return (tile + (temps if level < 1 else 0)
            + (states + small if level < 2 else 0))


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def lists_bytes(n: int) -> int:
    """Bytes of one graph's working lists (csrc/mono.cu Lists): the
    working pairs as 16-bit indices, the scan's bit words and bases per 32
    pairs, each node's list end, the working count and the re-coded
    incidence entries."""
    p, np_ = n * (n - 1) // 2, -(-n // 16) * 16
    nc = -(-p // 32)
    return _r16(2 * p) + 2 * _r16(4 * nc) + _r16(4 * np_) + 16 + 8 * p


def launch_bytes(n: int, h: int, itemsize: int, level: int) -> Tuple[int,
                                                                       int]:
    """(dynamic shared memory, scratch bytes per graph) of a launch at a
    layout level (csrc/mono.cu mono_launch): the shared regions, the bf16
    weight region where it fits after them, then the working lists in
    shared memory where they fit, else after the node regions in the
    scratch."""
    states, small, temps, _ = region_bytes(n, h, itemsize)
    shared = smem_bytes(n, h, itemsize, level)
    staged = -(-shared // 128) * 128 + weight_region_bytes(h)
    if itemsize == 2 and staged <= MAX_SMEM:
        shared = staged
    node = (temps if level >= 1 else 0) + (states + small if level >= 2
                                           else 0)
    if _r16(shared) + lists_bytes(n) <= MAX_SMEM:
        return _r16(shared) + lists_bytes(n), -(-node // 256) * 256
    return shared, -(-(-(-node // 256) * 256 + lists_bytes(n)) // 256) * 256


def weight_region_bytes(h: int) -> int:
    """The bf16 weights staged at once (csrc/mono.cu), at padded rows: the
    filter trio, a score head, or one node-side or encoder matrix."""
    fw = h + h // 2
    filters = h * (fw + 8) + h * (h + 8) + (h // 2) * (h // 2 + 8)
    head = 2 * h * (h + 8) + h * (h // 2 + 8)
    return 2 * max(filters, head, 2 * h * (h + 8))


def layout(n: int, h: int, itemsize: int) -> Tuple[int, int, int]:
    """(level, shared bytes, scratch bytes per graph of the launch): the
    smallest level that fits. The bf16 weights are staged where they fit
    beside it (to N = 16 at H = 128): restaging a product's weights for
    each call costs more than reading them from L2, so node regions in
    shared memory come first (PERF.md: at B=128, N=32 level 0 without
    staged weights reads ~0.8 ms of card time against ~0.9 at level 1 with
    them)."""
    fits = [lv for lv in (0, 1, 2)
            if smem_bytes(n, h, itemsize, lv) <= MAX_SMEM]
    if not fits:
        raise ValueError(f"H={h} needs {smem_bytes(n, h, itemsize, 2)} "
                         f"bytes of shared memory at every level")
    return (fits[0], *launch_bytes(n, h, itemsize, fits[0]))


def _pack(params: MonoParams, device) -> tuple:
    """Flat cd and f32 weight buffers and the int32 offset table the
    kernel indexes (csrc/mono.cu, enum order): the encoder's cd and f32
    entries, every block's cd entries (at bf16 also the filter matrices
    packed for the tensor-core tile, kernels/fused.py
    pack_filter_weights; empty at f32), every block's f32 entries, the GIN
    and head cd entries, then the GIN and head f32 entries. Each entry
    starts at a multiple of 16 elements."""
    cached = params._packed.get(device)
    if cached is not None:
        return cached
    w, cd = params.w, params.cd
    nb, nl = params.num_convs, params.num_local
    tparts, toffs, fparts, foffs = [], [], [], []

    def put(parts, offs, t, dtype):
        t = t.detach().reshape(-1).to(device=device, dtype=dtype)
        offs.append(sum(p.numel() for p in parts))
        pad = (-t.numel()) % 16
        parts.append(torch.cat([t, t.new_zeros(pad)]) if pad else t)

    def wt(t):
        put(tparts, toffs, t, cd)

    def wf(t):
        put(fparts, foffs, t, torch.float32)

    for k in ("kfe", "table0", "w0a", "w1", "table2", "w2a", "w3"):
        wt(w[k])                                          # E_*
    for k in ("bfe", "b1", "b3"):
        wf(w[k])                                          # EF_*
    for k in range(nb):
        wt(torch.cat([w["c1_fa"][k], w["c2_fa"][k]], 1))  # W_FA (H, FW)
        wt(w["c1_fb"][k])                                 # W_FB1
        wt(w["c2_fb"][k])                                 # W_FB2
        wt(torch.cat([w["c1_l1k"][k], w["c2_l1k"][k]], 1))  # W_L1
        wt(w["c1_l2k"][k])                                # W_L2A
        wt(w["c2_l2k"][k])                                # W_L2B
        wt(w["bk_link"][k])                               # W_LIN
        wt(w["bk_att0k"][k])                              # W_ATT0
        wt(w["bk_se0"][k])                                # W_SE0
        wt(w["bk_se1"][k])                                # W_SE1
        wt(pack_filter_weights(w["c1_fa"][k], w["c2_fa"][k], w["c1_fb"][k],
                               w["c2_fb"][k]) if cd == torch.bfloat16
           else w["w1"].new_zeros(0))                     # W_TC
    for k in range(nb):
        wf(torch.cat([w["c1_ba"][k], w["c2_ba"][k]]))     # F_BA
        wf(torch.cat([w["c1_bb"][k], w["c2_bb"][k]]))     # F_BB
        wf(torch.cat([w["c1_l1b"][k], w["c2_l1b"][k]]))   # F_L1B
        wf(w["c1_l2b"][k])                                # F_L2AB
        wf(w["c2_l2b"][k])                                # F_L2BB
        wf(w["bk_linb"][k])                               # F_LINB
        wf(w["bk_att0b"][k])                              # F_ATT0B
        wf(w["bk_att1k"][k])                              # F_ATT1K
        wf(w["bk_att1b"][k])                              # F_ATT1B
        wf(torch.cat([w["c1_beta"][k], w["c2_beta"][k],
                      w["bk_act_beta"][k]]))              # F_BETA
        wf(torch.cat([w[f"c{ci}_{n}"][k] for ci in (1, 2)
                      for n in ("dw1k", "dw1b", "dw2k")]))  # F_DW
        wf(torch.cat([w["c1_dw2b"][k], w["c2_dw2b"][k]]))  # F_DWB
    for li in range(nl):
        wt(w["gn_l0k"][li])                               # G_L0
        wt(w["gn_l1k"][li])                               # G_L1
    for s in range(2):
        wt(w["sc_g1a"][s])                                # S_W1H
        wt(w["sc_g1e"][s])                                # S_W1E
        wt(w["sc_g2k"][s])                                # S_W2
    for li in range(nl):
        wf(w["gn_l0b"][li])                               # GF_B0
        wf(w["gn_l1b"][li])                               # GF_B1
    for s in range(2):
        wf(w["sc_g1b"][s])                                # SF_B1
        wf(w["sc_g2b"][s])                                # SF_B2
        wf(w["sc_g3k"][s])                                # SF_W3
        wf(w["sc_g3b"][s])                                # SF_B3
    ot, of = toffs, foffs
    table = (ot[:7] + of[:3] + ot[7:7 + 11 * nb] + of[3:3 + 12 * nb]
             + ot[7 + 11 * nb:] + of[3 + 12 * nb:])
    packed = (torch.cat(tparts).contiguous(), torch.cat(fparts).contiguous(),
              torch.tensor(table, dtype=torch.int32, device=device))
    params._packed[device] = packed
    return packed


def _lib():
    from agdiff_torch.kernels import build

    lib = build.load("mono")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mono_launch.argtypes = ([i, i, i] + [p] * 17
                                    + [ctypes.c_longlong] + [i] * 9
                                    + [ctypes.c_float, p])
        lib.mono_launch.restype = i
        lib.mono_error_string.argtypes = [i]
        lib.mono_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(dp, em, lm, tp, h0, hl0, params: MonoParams, pairs: PairList,
            level=None):
    dev = dp.device
    if dev.type != "cuda":
        raise ValueError(f"mono_forward: unsupported device {dev}")
    cd = params.cd
    if cd not in DTYPES:
        raise TypeError(f"compute dtype {cd}: the kernel takes f32 or bf16")
    if params.act not in ("relu", "gelu"):
        raise NotImplementedError(f"head activation {params.act!r}")
    b, p = dp.shape
    n, h = h0.shape[1], h0.shape[2]
    nb, nl = params.num_convs, params.num_local
    dw = params.w["c1_dw1k"].shape[1]
    if h != params.hidden or h % 32 or dw % 4:
        raise ValueError(f"kernel needs H % 32 == 0 matching the weights "
                         f"and a distance-weight width % 4 == 0 (H={h}, "
                         f"DW={dw})")
    if not pairs.shared or pairs.tight or pairs.inc_ptr is None:
        raise ValueError("the kernel takes the bucket's triu pair list")
    if p != pairs.num_pairs or n != pairs.num_nodes or p != n * (n - 1) // 2:
        raise ValueError(f"pair list ({pairs.num_pairs}, {pairs.num_nodes}) "
                         f"does not match P={p}, N={n}")
    itemsize = 2 if cd == torch.bfloat16 else 4
    if level is None:
        level = layout(n, h, itemsize)[0]
    if smem_bytes(n, h, itemsize, level) > MAX_SMEM:
        raise ValueError(f"layout level {level} does not fit N={n}, H={h}")
    per_graph = launch_bytes(n, h, itemsize, level)[1]
    for name, t in (("dp", dp), ("em", em), ("lm", lm)):
        _check(name, t, (b, p), torch.float32, dev)
    _check("tp", tp, (b, p), torch.int32, dev)
    _check("h0", h0, (b, n, h), torch.float32, dev)
    _check("hl0", hl0, (b, n, h), torch.float32, dev)
    for name in ("iu", "ju"):
        _check(name, getattr(pairs, name), (p,), torch.int64, dev)
    _check("inc_ptr", pairs.inc_ptr, (n + 1,), torch.int32, dev)
    _check("inc", pairs.inc, (2 * p,), torch.int32, dev)
    wt, wf, offs = _pack(params, dev)
    out0 = torch.empty((b, p), dtype=torch.float32, device=dev)
    out1 = torch.empty((b, p), dtype=torch.float32, device=dev)
    e32 = params.buffer(dev, "e32", b * p * h * 4)
    scratch = params.buffer(dev, "nodes", b * per_graph)
    lib = _lib()
    ptrs = [dp, em, lm, tp, h0, hl0, pairs.iu, pairs.ju, pairs.inc_ptr,
            pairs.inc, wt, wf, offs, out0, out1, e32, scratch]
    hold(e32, scratch)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mono_launch(int(cd == torch.float32), int(params.smooth),
                              int(params.act == "gelu"),
                              *[t.data_ptr() for t in ptrs],
                              per_graph, b, n, p, h, dw, nb, nl,
                              pairs.inc_shift, level, float(params.cutoff),
                              stream)
    if err != 0:
        raise RuntimeError("mono kernel launch failed: "
                           + lib.mono_error_string(err).decode())
    launches[variant(cd, params.act)] += 1
    return out0, out1

