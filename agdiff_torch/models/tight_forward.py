"""Eval forward on a molecule's tight pair list (port of
agdiff_tpu/models/tight_forward.py, build_tight_forward :171-567).

A bucket of N = 64 holds molecules of 45-56 atoms at Drugs size: their
real pairs are 990-1540 of the bucket's 2016. The tight list
(ops/pairs.py prepare_pairs) holds only the real pairs, padded to a
capacity sized from the molecule (eval/generate.py), so per-pair work
scales with the molecule. The forward is models/fast_forward.py's on that
list: the working graph, the packed planes ANDed with the list's valid
plane (:416-426), the edge encoder on the packed pairs (:428-431), the
envelope (cosine with smooth_conv), the distance-weight planes (:446-447),
K1 (:461-478) or its plain version, and the mirror back to dense planes
(:380-386). The list depends only on the node mask, so the sampler builds
it once per ladder (`prepare`, :388-392) and passes it to every step.

Engines: 'tight' (f32, K1's plain version in mode 'full') and
'tight-approx' (the same with ops/approx.py's transcendentals);
'tight-pks', 'tight-pksg', 'tight-pksf' (bf16, K1 in mode 'schnet' /
'gin' / 'full', slim storage), each also with '-approx'; 'tight-slim'
and 'tight-slim8' (`TightXlaForward`, bf16: JAX's tight XLA path with
store_dtype bf16 or float8, :261-272, :312-352, :515-551), no hand
kernel; each with the suffix '-e16' (the edge encoder at bf16,
:273-284). As in the JAX package, the K1 engines take the score heads
unnarrowed (K1's products round them to bf16; its biases and last layer
stay f32) and need a shared list (:250-255). `tabulate=K`
(build_tight_forward, :289-297, :321-334) replaces every filter MLP,
distance weight and envelope by a K-row table per bond type, lerped at
each pair's distance (`build_filter_tables`).

The JAX package's runner leaves the '-e16' tight engines out of its
tight set (agdiff_tpu/eval/generate.py:34-36), so it gives them neither a
capacity nor a shared list and 'tight-pksf-e16' raises there; the port's
runner treats every name here as tight.
"""

from __future__ import annotations

from typing import Optional

import torch

from agdiff_torch.chem.constants import NUM_BOND_TYPES
from agdiff_torch.config import ModelConfig
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.fast_forward import (
    FastForward,
    XlaForward,
    edge_encode,
    engine_options,
    node_input,
    store,
)
from agdiff_torch.nn.common import shifted_softplus
from agdiff_torch.nn.schnet import envelope
from agdiff_torch.ops.pairs import (
    PairList,
    gather_nodes,
    pack_plane,
    prepare_pairs,
    prepare_pairs_shared,
    scatter_nodes,
)

_BASE = (("tight", "tight-approx")
         + tuple(f"tight-{k}{s}" for k in ("pks", "pksg", "pksf")
                 for s in ("", "-approx"))
         + ("tight-slim", "tight-slim8"))
ENGINES = _BASE + tuple(f"{e}-e16" for e in _BASE)


class TightForward(FastForward):
    """forward(batch, pairs=None) -> ModelOutput over tight pair lists;
    `capacity` is the static pair count (None: the bucket's N(N-1)/2,
    always enough); shared=True uses graph 0's list for the whole batch,
    which is right for one molecule repeated (the generation pattern)."""

    cast_heads = False
    name = "tight_forward"

    def __init__(self, config: ModelConfig, model: DualEncoderEpsNetwork,
                 *, capacity: Optional[int] = None, shared: bool = True,
                 **kw):
        if kw.get("mode") is not None and not shared:
            raise ValueError("the K1 modes need shared=True: the kernel takes "
                             "one pair list for the whole batch")
        super().__init__(config, model, **kw)
        self.capacity, self.shared = capacity, shared

    def prepare(self, batch, capacity: Optional[int] = None) -> PairList:
        n = batch.atom_type.shape[1]
        cap = capacity or self.capacity or n * (n - 1) // 2
        fn = prepare_pairs_shared if self.shared else prepare_pairs
        return fn(batch.node_mask, cap)


class TightXlaForward(TightForward, XlaForward):
    """JAX's tight XLA path (tight_forward.py:336-352, :380-386, :515-551
    of the JAX package): engines 'tight-slim', 'tight-slim8' (compute
    bf16) and `tabulate` (the compute dtype of its engine). It rounds
    where the JAX tight path does, which is not where the triu path
    (XlaForward) does: each filter times its distance weight is stored at
    the store dtype (the compute dtype without one) and read back at the
    compute dtype; the node inputs come from h rounded to the compute
    dtype; each message t * x_j is rounded to the compute dtype, and the
    sums onto endpoint i and onto endpoint j are each rounded to it before
    they are added. The score heads' weights are cast to the compute dtype
    at each product, their last bias stays f32 (:355-372)."""

    def __init__(self, config: ModelConfig, model: DualEncoderEpsNetwork,
                 *, capacity: Optional[int] = None, shared: bool = True,
                 tabulate: int = 0, **kw):
        super().__init__(config, model, capacity=capacity, shared=shared,
                         **kw)
        self.tabulate = tabulate
        if tabulate:
            self.table, self.offs = build_filter_tables(
                config, self, tabulate, self.compute_dtype)

    def filter_context(self, kw, dist, edge_type, edge_mask):
        """With `tabulate`, every conv's filter rows of each pair, lerped
        from the table (tight_forward.py:321-334 of the JAX package)."""
        if not self.tabulate:
            return None
        pairs, cd = kw["pairs"], self.compute_dtype
        res, cutoff = self.tabulate, self.config.cutoff
        d = pack_plane(dist, pairs)
        em = pack_plane(edge_mask, pairs).float() * pairs.valid
        x = torch.clamp(d / (cutoff / (res - 1)), 0.0, res - 1.0)
        i0 = torch.clamp(torch.floor(x).long(), 0, res - 2)
        frac = (x - i0.float()).to(cd)
        base = pack_plane(edge_type, pairs).long() * res + i0
        r0, r1 = self.table[base], self.table[base + 1]
        rows = r0 + frac[..., None] * (r1 - r0)
        gate = ((d <= cutoff) & (d >= 0.0)).float() * em
        return rows * gate[..., None].to(cd)

    def block_aggregates(self, k, blk, h, kw, ctx):
        cd, pairs = self.compute_dtype, kw["pairs"]
        h_cd = h.to(cd).float()
        out = []
        for s, conv in enumerate(blk["convs"]):
            if ctx is not None:
                t = ctx[..., self.offs[2 * k + s]:self.offs[2 * k + s + 1]]
            else:
                wp = self.filter(conv, kw["e_packed"]) \
                    * kw["we"][2 * k + s][..., None]
                t = store(wp, self.store_dtype or cd, cd)
            x = node_input(conv, h_cd).to(cd)
            a_i = torch.zeros(x.shape[:2] + t.shape[-1:], device=x.device)
            a_j = torch.zeros_like(a_i)
            scatter_nodes(a_i, pairs.iu, (t * gather_nodes(x, pairs.ju))
                          .float())
            scatter_nodes(a_j, pairs.ju, (t * gather_nodes(x, pairs.iu))
                          .float())
            out.append((a_i.to(cd) + a_j.to(cd)).float())
        return out


def build_filter_tables(config: ModelConfig, fwd: FastForward,
                        resolution: int, dtype: torch.dtype):
    """Every conv's filter weight as a function of a pair's distance and
    bond type (tight_forward.py:131-169 of the JAX package): per type,
    `resolution` distances evenly over [0, cutoff], through the exact edge
    encoder, filter MLP, distance weight and envelope. Returns the table
    (types * resolution, sum of the widths), type-major, at `dtype`, and
    each conv's column offsets."""
    dev = fwd.schnet_emb.device
    num_types = NUM_BOND_TYPES + max(config.edge_order, 1)
    d = torch.linspace(0.0, config.cutoff, resolution, device=dev)[:, None]
    env = envelope(d[:, 0], config.cutoff, config.smooth_conv)
    convs = [conv for blk in fwd.blocks for conv in blk["convs"]]
    cols = []
    for t in range(num_types):
        types = torch.full((resolution,), t, dtype=torch.long, device=dev)
        e = edge_encode(fwd.ee, d, types)
        rows = []
        for conv in convs:
            (k1, b1), (k2, b2) = conv["dw1"], conv["dw2"]
            lw = torch.sigmoid(torch.relu(d * k1[0] + b1) @ k2 + b2)[..., 0]
            v = shifted_softplus(e @ conv["fa"][0].float() + conv["fa"][1],
                                 conv["beta"])
            rows.append((v @ conv["fb"][0].float() + conv["fb"][1])
                        * (lw * env)[:, None])
        cols.append(torch.cat(rows, -1))
    widths = [conv["fb"][0].shape[1] for conv in convs]
    offs = [0] + [int(x) for x in torch.tensor(widths).cumsum(0)]
    return torch.cat(cols, 0).to(dtype), offs


def build_tight_forward(config: ModelConfig, model: DualEncoderEpsNetwork,
                        engine: str = "tight",
                        capacity: Optional[int] = None,
                        tabulate: int = 0) -> TightForward:
    """The forward of a tight engine (ENGINES) over shared lists;
    `tabulate` > 0 (engines 'tight' and 'tight-slim*') looks the filters
    up in tables of that many distances per bond type."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES}")
    opts = engine_options(engine)
    if opts.mode == "xla" or tabulate:
        if opts.mode not in (None, "xla"):
            # agdiff_tpu/models/tight_forward.py:239-242
            raise ValueError("the K1 engines recompute the filters in the "
                             "kernel; tabulate is for 'tight' and "
                             "'tight-slim*'")
        cd = torch.float32 if opts.store is None else torch.bfloat16
        return TightXlaForward(config, model, capacity=capacity,
                               compute_dtype=cd, store_dtype=opts.store,
                               approx=opts.approx, edge_dtype=opts.edge,
                               tabulate=tabulate)
    cd = torch.float32 if opts.mode is None else torch.bfloat16
    return TightForward(config, model, capacity=capacity, mode=opts.mode,
                        compute_dtype=cd, approx=opts.approx,
                        edge_dtype=opts.edge)
