"""Eval forward on a pair list (port of agdiff_tpu/models/fast_forward.py:
the paths generation runs).

Value-preserving rewrites of the module path (models/dualenc.py):
BatchNorm folded into the preceding Linears, the identity softmax of the
edge encoder skipped, every per-edge tensor on a list of unordered pairs
(ops/pairs.py). This module's forward takes the bucket's full triu set;
models/tight_forward.py takes a molecule's tight list through the same
code. After the edge encoder K1 (kernels/stack_packed.py) runs the stack
in one of its modes, and the rest runs here in plain PyTorch:

* mode None (engine None, f32): K1's plain version in mode 'full', which
  at f32 is the JAX package's f32 packed XLA path up to summation order;
* 'pks' / 'pksg' / 'pksf' (bf16, fast_forward.py:678-705 of the JAX
  package): K1 in mode 'schnet' / 'gin' / 'full', then the GIN layers
  and the pair-score heads that the mode leaves (`gin_tail`,
  `pair_scores`); with the slim engines' narrow storage, the filter
  weights and the score heads are bf16;
* 'pk' (bf16, fast_forward.py:550-563 of the JAX package): 'pks' with
  K1 replaced by one K2 launch per interaction block
  (kernels/block_packed.py: both filter MLPs and the aggregation on the
  packed pairs) and the block's node tail (`schnet_block`) here;
* the suffix '-approx' on a kernel engine swaps softplus, sigmoid and
  gelu for ops/approx.py's forms, in the edge encoder, the distance
  weights, the gelu of gelu score heads and inside the kernels
  (sampling/langevin.py:388-394, fast_forward.py:325-345 of the JAX
  package);
* 'pallas' (`PallasForward`, the config's dtype; fast_forward.py:574-580,
  :753-758 of the JAX package): the dense (B, N, N, C) layout, one K3
  launch per interaction block (kernels/fused.py), the GIN layers through
  K5 at f32 and an f32 einsum at bf16, and the score heads on the packed
  pairs; with pack_pairs=False the edge encoder runs over all N^2 ordered
  pairs and both heads go through K4. It has no '-approx' form, as in the
  JAX package (:303-304);
* 'approx' (f32): the plain f32 forward with ops/approx.py's softplus,
  sigmoid and gelu, the heads' gelu included (sampling/langevin.py:
  388-394 of the JAX package);
* 'slim' (and its alias 'slim2') and 'slim8' (`XlaForward`, bf16): the
  JAX package's XLA path with narrow storage (fast_forward.py:251-262,
  :363-385, :463-486): store_dtype bf16 or float8_e4m3fn, filter_dtype
  the compute dtype. Each filter MLP's output is stored narrow and read
  back at bf16 before its product with the distance weight, the GIN
  messages read the local edge features through the narrow store, and
  the score heads run at bf16 with an f32 last sum. No hand kernel: JAX
  runs these engines in XLA. float8 follows JAX's rounding (`to_float8`:
  past 464 in magnitude JAX gives NaN where PyTorch saturates at 448);
* 'stack' (`XlaForward`, f32; :386-446 of the JAX package): the XLA path
  with the twelve filter MLPs as one wide first layer and two grouped
  second layers, each block's two filters aggregated at once;
* the suffix '-e16' on any engine but 'pallas' (edge_dtype bf16,
  :349-362): the edge encoder's layers after the f32 length expansion
  run at bf16.

Where the XLA path in JAX mirrors a per-pair tensor to the dense layout
and contracts it, the port sums the same products over the pair list's
endpoints in f32: equal up to summation order for finite values (a
non-finite filter on a masked cell, which JAX's dense product spreads,
stays out of the port's sum).

On a card each kernel is the hand-written CUDA kernel; CPU tensors take
its plain version. Every engine here takes the 'mlp' edge encoder only, as
in the JAX package; a 'gaussian' model runs on the module path.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from agdiff_torch.config import ModelConfig
from agdiff_torch.kernels.block_packed import packed_block_aggregate
from agdiff_torch.kernels.fused import (
    gine_aggregate,
    interaction_block_aggregate,
    pair_score_mlp,
)
from agdiff_torch.kernels.stack_packed import (
    StackParams,
    head_activation,
    packed_stack_forward,
    packed_stack_forward_plain,
)
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork, ModelOutput
from agdiff_torch.nn.common import LN2, gelu
from agdiff_torch.nn.schnet import embed_max_norm, envelope
from agdiff_torch.ops import approx as ax
from agdiff_torch.ops.graph import working_graph
from agdiff_torch.ops.pairs import (
    PairList,
    gather_nodes,
    mirror_features,
    mirror_plane,
    pack_plane,
    scatter_nodes,
    triu_pairs,
)

# engine -> K1 mode; 'blocks' is K2 per block (engine 'pk'), 'dense' the
# dense-layout engine 'pallas'
KERNEL_MODES = {"pks": "schnet", "pksg": "gin", "pksf": "full",
                "pk": "blocks"}
# the engines of JAX's XLA path, name -> (mode, store dtype): 'xla' with
# narrow storage, 'stack' with the stacked filters
XLA_ENGINES = {"slim": ("xla", torch.bfloat16),
               "slim2": ("xla", torch.bfloat16),
               "slim8": ("xla", torch.float8_e4m3fn),
               "stack": ("stack", None)}
_BASE = ((None, "pallas") + tuple(f"{k}{s}" for k in KERNEL_MODES
                                  for s in ("", "-approx"))
         + ("approx",) + tuple(XLA_ENGINES))
ENGINES = _BASE + tuple(f"{e}-e16" for e in _BASE if e not in (None,
                                                                "pallas"))


class Engine(NamedTuple):
    """What an engine name asks for (`engine_options`)."""

    tight: bool
    # None, a K1 mode, 'blocks', 'dense', 'xla' or 'stack'
    mode: Optional[str]
    approx: bool
    store: Optional[torch.dtype] = None   # the slim engines' storage
    edge: Optional[torch.dtype] = None    # '-e16': the encoder's dtype


def engine_options(engine: Optional[str]) -> Engine:
    """The options of an engine name: [tight-]pks|pksg|pksf[-approx],
    pk[-approx], 'pallas', [tight-]slim|slim2|slim8, 'stack', 'approx',
    'tight-approx', 'tight' or None (the plain f32 forward), each but
    'pallas' with the suffix '-e16' (sampling/langevin.py:374-405 of the
    JAX package)."""
    name = engine or ""
    edge = None
    if name.endswith("-e16"):
        edge, name = torch.bfloat16, name[:-len("-e16")]
    approx = name in ("approx", "tight-approx") or name.endswith("-approx")
    if approx:
        name = {"approx": "", "tight-approx": "tight"}.get(
            name, name[:-len("-approx")])
    if name == "pallas":
        if approx or edge is not None:
            # agdiff_tpu/models/fast_forward.py:303-304
            raise ValueError("approx engines use the XLA path "
                             "(use_pallas=False); 'pallas' has no "
                             "'-approx' or '-e16' form here")
        return Engine(False, "dense", False)
    tight = name == "tight" or name.startswith("tight-")
    name = name[len("tight-"):] if name.startswith("tight-") else (
        "" if name == "tight" else name)
    if name in KERNEL_MODES:
        return Engine(tight, KERNEL_MODES[name], approx, None, edge)
    if name in XLA_ENGINES:
        mode, store_dtype = XLA_ENGINES[name]
        return Engine(tight, mode, approx, store_dtype, edge)
    if name == "":
        return Engine(tight, None, approx, None, edge)
    raise ValueError(f"unknown engine {engine!r}")


def to_float8(x):
    """x as float8_e4m3fn with JAX's rounding (ml_dtypes): round to
    nearest even, and NaN past 464 in magnitude (the last tie, between
    448 and the NaN code) and for inf, where PyTorch's cast saturates at
    +-448; elsewhere the two agree bit for bit."""
    bits = x.to(torch.float8_e4m3fn).view(torch.uint8)
    bits = torch.where(x.abs() > 464.0, bits | 0x7F, bits)
    return bits.view(torch.float8_e4m3fn)


def store(x, dtype: torch.dtype, cd: torch.dtype):
    """x stored at `dtype` and read back at the compute dtype cd (the JAX
    XLA path's astype(store_dtype).astype(compute_dtype))."""
    if dtype == torch.float8_e4m3fn:
        return to_float8(x).to(cd)
    return x.to(dtype).to(cd)


def _linear(layer):
    """(kernel (in, out), bias) of a torch Linear."""
    return layer.weight.detach().t(), (None if layer.bias is None
                                       else layer.bias.detach())


def _fold_bn(kernel, bias, bn, eps=1e-5):
    """BN(xW + b) = x (W * g) + ((b - mean) * g + beta),
    g = scale / sqrt(var + eps)."""
    inv = bn.weight.detach() / torch.sqrt(bn.running_var + eps)
    return kernel * inv[None, :], (bias - bn.running_mean) * inv \
        + bn.bias.detach()


def fold_eval_params(model: DualEncoderEpsNetwork) -> Dict:
    """Fold eval-mode BatchNorm into the preceding Linears and flatten the
    module into plain dicts of tensors (kernels in (in, out) layout)."""
    cfg = model.config
    enc = model.encoder_global
    blocks = []
    for i in range(cfg.num_convs):
        blk = getattr(enc, f"interactions_{i}")
        se = getattr(enc, f"scaling_modules_{i}")
        convs = []
        for conv in (blk.conv1, blk.conv2):
            convs.append(dict(
                dw1=_linear(conv.distance_weighting.layer1),
                dw2=_linear(conv.distance_weighting.layer2),
                fa=_linear(conv.filter_0),
                beta=conv.filter_act.beta.detach(),
                fb=_linear(conv.filter_1),
                lin1=_fold_bn(*_linear(conv.lin1), conv.norm1),
                lin2=_fold_bn(*_linear(conv.lin2), conv.norm2),
            ))
        blocks.append(dict(
            convs=convs, act_beta=blk.act.beta.detach(),
            lin=_linear(blk.lin), att0=_linear(blk.attention_0),
            att1=_linear(blk.attention_1),
            se0=_linear(se.fc_0)[0], se1=_linear(se.fc_1)[0],
        ))
    gin = model.encoder_local
    gin_layers = []
    for i in range(cfg.num_convs_local):
        mlp = getattr(gin, f"convs_{i}").nn
        gin_layers.append(dict(
            l0=_linear(mlp.layers_0),
            l1=_fold_bn(*_linear(mlp.layers_1),
                        getattr(gin, f"batch_norms_{i}")),
        ))

    def mlp3(m):
        return sum((_linear(getattr(m, f"layers_{k}")) for k in range(3)),
                   ())

    return dict(
        ee=model.edge_encoder_global,
        ee_local=(None if cfg.tie_edge_encoders
                  else model.edge_encoder_local),
        blocks=blocks,
        schnet_emb=enc.embedding.weight.detach(),
        gin_layers=gin_layers,
        gin_emb=gin.node_emb.weight.detach(),
        grad_global=mlp3(model.grad_global_dist_mlp),
        grad_local=mlp3(model.grad_local_dist_mlp),
    )


def edge_encode(ee, edge_length, edge_type, act=gelu, dtype=None):
    """MLPEdgeEncoder minus the identity softmax attention; the length
    expansion is elementwise (its Linear has one input). With `dtype`
    (engines '-e16') the layers after the expansion, their weights and
    the bond embedding run at that dtype; the expansion stays f32
    (fast_forward.py:142-163 of the JAX package)."""

    def linear(layer):
        k, b = _linear(layer)
        return (k, b) if dtype is None else (k.to(dtype), b.to(dtype))

    k, b = _linear(ee.feature_expansion)
    expanded = act(edge_length * k[0] + b)
    bond = ee.bond_emb.weight.detach()[edge_type]
    if dtype is not None:
        expanded, bond = expanded.to(dtype), bond.to(dtype)
    k, b = linear(ee.edge_feature_mlp_0)
    x = act(torch.cat([expanded, bond], dim=-1) @ k + b)
    k, b = linear(ee.edge_feature_mlp_1)
    x = x @ k + b
    y = torch.cat([x, bond], dim=-1)
    k, b = linear(ee.combination_mlp_0)
    y = act(y @ k + b)
    k, b = linear(ee.combination_mlp_1)
    return y @ k + b


def stacked_distance_weights(blocks, el, env, sigmoid=torch.sigmoid):
    """All 2*NB distance-weight x envelope planes as one (2*NB, B, P)
    tensor: sigmoid(relu(el * k1 + b1) . k2 + b2) * env per conv."""
    convs = [conv for blk in blocks for conv in blk["convs"]]
    k1 = torch.stack([c["dw1"][0][0] for c in convs])        # (C, W)
    b1 = torch.stack([c["dw1"][1] for c in convs])           # (C, W)
    k2 = torch.stack([c["dw2"][0][:, 0] for c in convs])     # (C, W)
    b2 = torch.stack([c["dw2"][1][0] for c in convs])        # (C,)
    x = torch.relu(el[..., None] * k1 + b1)                  # (B, P, C, W)
    y = sigmoid(torch.einsum("bpcw,cw->cbp", x, k2) + b2[:, None, None])
    return y * env[None]


def pair_scores(p6, h, e, pairs: PairList, act, cd, wd=None):
    """A pair-score head on the list: MLP3(concat(h_i * h_j, e)) -> (B, P)
    f32 (tight_forward.py:355-378, fast_forward.py:488-521 of the JAX
    package). h_i * h_j and e are taken at cd; the weights and the
    arithmetic at wd (default cd). At bf16 with slim storage (wd bf16)
    every product outputs bf16 and the last layer sums in f32; engine
    'pallas' at bf16 keeps the weights f32 (wd f32), so its bf16-rounded
    inputs meet f32 arithmetic (fast_forward.py:499-519); at f32
    everything is f32."""
    w1, b1, w2, b2, w3, b3 = p6
    wd = wd or cd
    c = h.shape[-1]
    hb = h.to(cd)
    prod = gather_nodes(hb, pairs.iu) * gather_nodes(hb, pairs.ju)
    x = act(prod.to(wd) @ w1[:c].to(wd) + e.to(cd).to(wd) @ w1[c:].to(wd)
            + b1.to(wd))
    y = act(x @ w2.to(wd) + b2.to(wd))
    return (y.float() @ w3.to(wd).float() + b3.float())[..., 0]


def node_input(conv, h):
    """A conv's node input leaky_relu(h @ lin1 + b, 0.2), f32
    (fast_forward.py:200-202 of the JAX package)."""
    k, b = conv["lin1"]
    return F.leaky_relu(h @ k + b, 0.2)


def schnet_block(blk, h, a1, a2, softplus=F.softplus, sigmoid=torch.sigmoid):
    """The node tail of one interaction block on its two aggregates, f32
    (fast_forward.py:587-603 of the JAX package): lin2 per conv, shifted
    softplus, the combination linear, the relu -> sigmoid attention gate,
    the SE gate, the residual. Returns the new h."""
    c1, c2 = blk["convs"]
    p1 = a1 @ c1["lin2"][0] + c1["lin2"][1]
    p2 = a2 @ c2["lin2"][0] + c2["lin2"][1]
    comb = softplus(blk["act_beta"] * torch.cat([p1, p2], -1)) - LN2
    comb = comb @ blk["lin"][0] + blk["lin"][1]
    gate = torch.relu(comb @ blk["att0"][0] + blk["att0"][1])
    gate = sigmoid(gate @ blk["att1"][0] + blk["att1"][1])
    out = comb * gate
    out = out * sigmoid(torch.relu(out @ blk["se0"]) @ blk["se1"])
    return h + out


def gin_layer(layer, hl, agg, last: bool):
    """A GIN layer's node MLP and residual on its aggregate, f32."""
    out = torch.relu((hl + agg) @ layer["l0"][0] + layer["l0"][1])
    out = out @ layer["l1"][0] + layer["l1"][1]
    return (out if last else torch.relu(out)) + hl


def gin_tail(layers, hl, e_local, local_mask_p, pairs: PairList, cd):
    """The GIN layers on the list (tight_forward.py:523-551,
    fast_forward.py:741-772 of the JAX package): messages relu(hl_j + e)
    masked by the local plane, at the compute dtype, summed onto the
    endpoints in f32; the node MLP in f32."""
    e = e_local.to(cd)
    lm = local_mask_p.to(cd)[..., None]
    for i, layer in enumerate(layers):
        hb = hl.to(cd)
        m_i = torch.relu(gather_nodes(hb, pairs.ju) + e) * lm   # into i
        m_j = torch.relu(gather_nodes(hb, pairs.iu) + e) * lm   # into j
        agg = torch.zeros_like(hl)
        scatter_nodes(agg, pairs.iu, m_i.float())
        scatter_nodes(agg, pairs.ju, m_j.float())
        hl = gin_layer(layer, hl, agg, i == len(layers) - 1)
    return hl


def mirrored_output(sg, sl, pairs: PairList, edge_mask, edge_type,
                    local_mask, dist) -> ModelOutput:
    """The packed score planes mirrored to dense, zero off their masks."""
    zero = torch.zeros((), device=dist.device)
    return ModelOutput(
        edge_inv_global=torch.where(edge_mask, mirror_plane(sg, pairs),
                                    zero),
        edge_inv_local=torch.where(local_mask, mirror_plane(sl, pairs),
                                   zero),
        edge_mask=edge_mask, edge_type=edge_type, edge_length=dist,
        local_mask=local_mask,
    )


def endpoint_sum(t, x, pairs: PairList):
    """Per pair, t times the node rows at the other endpoint, summed onto
    each endpoint in f32: (B, P, F), (B, N, F) -> (B, N, F). Pad slots
    carry t = 0."""
    out = torch.zeros(x.shape[:2] + t.shape[-1:], device=x.device)
    scatter_nodes(out, pairs.iu, (t * gather_nodes(x, pairs.ju)).float())
    return scatter_nodes(out, pairs.ju,
                         (t * gather_nodes(x, pairs.iu)).float())


class FastForward:
    """forward(batch, pairs=None) -> ModelOutput over the bucket's triu
    pair set. mode None runs K1's plain version in mode 'full' (the f32
    engine); a K1 mode runs K1 through its wrapper, mode 'blocks' K2 once
    per interaction block, and the remaining layers run in plain PyTorch.
    compute_dtype bf16 narrows the filter weights and products as the JAX
    slim engines do."""

    cast_heads = True   # slim storage: score heads in bf16 before K1
    name = "fast_forward"   # the JAX module this class ports (messages)

    def __init__(self, config: ModelConfig, model: DualEncoderEpsNetwork,
                 *, mode: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 approx: bool = False,
                 edge_dtype: Optional[torch.dtype] = None):
        if config.edge_encoder != "mlp":
            # agdiff_tpu/models/fast_forward.py:292-295,
            # tight_forward.py:212-215
            raise NotImplementedError(
                f"{self.name} supports the 'mlp' edge encoder (both "
                "reference configs); use the module path for 'gaussian'.")
        if mode is not None and mode not in KERNEL_MODES.values():
            raise ValueError(f"mode {mode!r}")
        self.config = config
        self.mode, self.approx = mode, approx
        self.edge_dtype = edge_dtype   # '-e16': the encoder at bf16
        cd = self.compute_dtype = compute_dtype
        # the score heads' act: under approx a gelu head takes ops/
        # approx.py's gelu, as in JAX (fast_forward.py:331, :345)
        self.act = head_activation(config.mlp_act, approx)
        self.gelu = ax.gelu if approx else gelu
        self.sigmoid = ax.sigmoid if approx else torch.sigmoid
        self.softplus = ax.softplus if approx else F.softplus
        folded = fold_eval_params(model)
        self.ee, self.ee_local = folded["ee"], folded["ee_local"]
        self.blocks = folded["blocks"]
        self.schnet_emb, self.gin_emb = folded["schnet_emb"], folded["gin_emb"]
        self.gin_layers = folded["gin_layers"]
        grad_global, grad_local = folded["grad_global"], folded["grad_local"]
        # filter weights at the compute dtype (slim storage at bf16), laid
        # out as the K2 and K3 kernels read them
        for blk in self.blocks:
            for conv in blk["convs"]:
                conv["fa"] = (conv["fa"][0].to(cd).contiguous(), conv["fa"][1])
                conv["fb"] = (conv["fb"][0].to(cd).contiguous(), conv["fb"][1])
        if cd == torch.bfloat16:
            if self.cast_heads:  # slim storage: score heads at bf16
                grad_global = tuple(p.to(cd) for p in grad_global)
                grad_local = tuple(p.to(cd) for p in grad_local)
        self.stack = StackParams(self.blocks, self.gin_layers, grad_global,
                                 grad_local, act=config.mlp_act)
        self._pairs: Dict[tuple, PairList] = {}
        self.calls = 0  # forwards run (chip_smoke.py checks the launches)

    def prepare(self, batch, capacity: Optional[int] = None) -> PairList:
        """The pair list of this batch's bucket (built once per size)."""
        n, dev = batch.atom_type.shape[1], batch.atom_type.device
        key = (n, str(dev))
        if key not in self._pairs:
            self._pairs[key] = triu_pairs(n, dev)
        return self._pairs[key]

    @torch.no_grad()
    def stack_inputs(self, batch, pairs: Optional[PairList] = None, *,
                     extend_order: bool = False, extend_radius: bool = True):
        """Everything before K1: the working graph (ops/graph.py
        working_graph), the packed edge features and planes (zero at pad
        slots), the initial node states. Returns K1's keyword arguments
        and the dense masks (edge_mask, edge_type, local_mask, dist)."""
        cfg, cd = self.config, self.compute_dtype
        pairs = pairs if pairs is not None else self.prepare(batch)
        dist, edge_mask, edge_type, local_mask = working_graph(
            batch, cfg.cutoff, cfg.edge_order, extend_order=extend_order,
            extend_radius=extend_radius)
        el_packed = pack_plane(dist, pairs)[..., None]
        type_packed = pack_plane(edge_type, pairs)
        e_packed = edge_encode(self.ee, el_packed, type_packed, self.gelu,
                               self.edge_dtype).to(cd)
        e_packed_local = (e_packed if self.ee_local is None else
                          edge_encode(self.ee_local, el_packed, type_packed,
                                      self.gelu, self.edge_dtype).to(cd))
        h = embed_max_norm(self.schnet_emb, batch.atom_type,
                           cfg.embedding_max_norm)
        # a pad slot's cell can be a valid pair's mirror: AND with valid
        em_p = pack_plane(edge_mask, pairs).float() * pairs.valid
        lm_p = pack_plane(local_mask, pairs).float() * pairs.valid
        env_p = envelope(el_packed[..., 0], cfg.cutoff, cfg.smooth_conv) * em_p
        we = stacked_distance_weights(self.blocks, el_packed, env_p,
                                      self.sigmoid)
        kwargs = dict(
            e_packed=e_packed.contiguous(), we=we.contiguous(),
            h0=h.float().contiguous(), params=self.stack,
            e_packed_local=e_packed_local.contiguous(), local_mask_p=lm_p,
            hl0=self.gin_emb[batch.atom_type].contiguous(), pairs=pairs)
        return kwargs, (edge_mask, edge_type, local_mask, dist)

    @torch.no_grad()
    def __call__(self, batch, pairs: Optional[PairList] = None, *,
                 extend_order: bool = False, extend_radius: bool = True
                 ) -> ModelOutput:
        self.calls += 1
        kw, (edge_mask, edge_type, local_mask, dist) = self.stack_inputs(
            batch, pairs, extend_order=extend_order,
            extend_radius=extend_radius)
        pairs, cd = kw["pairs"], self.compute_dtype
        if self.mode is None:
            sg, sl = packed_stack_forward_plain(**kw, approx=self.approx)
        else:
            res = (self.pk_blocks(kw) if self.mode == "blocks" else
                   packed_stack_forward(**kw, mode=self.mode,
                                        approx=self.approx))
            if self.mode == "full":
                sg, sl = res
            else:
                h, hl = res if self.mode == "gin" else (res, None)
                if hl is None:
                    hl = gin_tail(self.gin_layers, kw["hl0"],
                                  kw["e_packed_local"], kw["local_mask_p"],
                                  pairs, cd)
                sg = pair_scores(self.stack.grad_global, h, kw["e_packed"],
                                 pairs, self.act, cd)
                sl = pair_scores(self.stack.grad_local, hl,
                                 kw["e_packed_local"], pairs, self.act, cd)
        return mirrored_output(sg, sl, pairs, edge_mask, edge_type,
                               local_mask, dist)

    def pk_blocks(self, kw):
        """Engine 'pk': the interaction blocks as one K2 launch each on
        K1's inputs, then the block's node tail; returns h (B, N, H) f32
        (fast_forward.py:550-563 of the JAX package)."""
        h, we, cd = kw["h0"], kw["we"], self.compute_dtype
        for k, blk in enumerate(self.blocks):
            c1, c2 = blk["convs"]
            a1, a2 = packed_block_aggregate(
                kw["e_packed"], we[2 * k], we[2 * k + 1],
                node_input(c1, h).to(cd), node_input(c2, h).to(cd), c1, c2,
                kw["pairs"], approx=self.approx)
            h = schnet_block(blk, h, a1, a2, self.softplus, self.sigmoid)
        return h


class XlaForward(FastForward):
    """The JAX package's XLA path over a pair list, no hand kernel
    (fast_forward.py:363-521, :650-800 of the JAX package, pack_pairs
    with score_dots): engines 'slim', 'slim2', 'slim8' (compute bf16,
    store_dtype bf16 or float8, filter_dtype bf16) and 'stack' (f32,
    stack_filters). Per interaction block each filter MLP runs on the
    pairs with f32 sums (filter_dtype operands); under store_dtype its
    output is stored narrow, read back at bf16 and multiplied by the
    distance weight at bf16, and the messages t * x_j are summed in f32
    from bf16 operands; the node tail, h and hl stay f32. The GIN layers
    read the local edge features through the narrow store (`gin_tail`),
    and the score heads run at the compute dtype (`pair_scores`)."""

    def __init__(self, config: ModelConfig, model: DualEncoderEpsNetwork,
                 *, compute_dtype: torch.dtype = torch.float32,
                 store_dtype: Optional[torch.dtype] = None,
                 stack: bool = False, approx: bool = False,
                 edge_dtype: Optional[torch.dtype] = None):
        super().__init__(config, model, compute_dtype=compute_dtype,
                         approx=approx, edge_dtype=edge_dtype)
        self.mode = "stack" if stack else "xla"
        self.store_dtype = store_dtype
        self.stacked = stacked_filter_params(self.blocks) if stack else None

    def ssp(self, x, beta):
        return self.softplus(beta * x) - LN2

    def filter(self, conv, e):
        """A conv's filter MLP on the pairs, f32 (B, P, F): filter_dtype
        operands (the weights' dtype), f32 sums."""
        fdt = conv["fa"][0].dtype
        v = self.ssp(e.to(fdt).float() @ conv["fa"][0].float()
                     + conv["fa"][1], conv["beta"])
        return v.to(fdt).float() @ conv["fb"][0].float() + conv["fb"][1]

    def stacked_filters(self, e, we):
        """All 2*NB filters as one wide first layer and two grouped second
        layers, times their distance weights (fast_forward.py:407-446 of
        the JAX package): per block (B, P, F1 + F2) f32."""
        st, nb = self.stacked, len(self.blocks)
        fdt, offs = st["fa_k"].dtype, st["offs"]
        v = self.ssp(e.to(fdt).float() @ st["fa_k"].float() + st["fa_b"],
                     st["beta"])
        v1 = torch.stack([v[..., offs[2 * i]:offs[2 * i + 1]]
                          for i in range(nb)], dim=2).to(fdt).float()
        v2 = torch.stack([v[..., offs[2 * i + 1]:offs[2 * i + 2]]
                          for i in range(nb)], dim=2).to(fdt).float()
        w1 = torch.einsum("bpkh,khf->bpkf", v1, st["fb1_k"].float()) \
            + st["fb1_b"]
        w2 = torch.einsum("bpkh,khf->bpkf", v2, st["fb2_k"].float()) \
            + st["fb2_b"]
        we = we.permute(1, 2, 0)                       # (B, P, 2 * NB)
        w1 = w1 * we[:, :, 0::2, None]
        w2 = w2 * we[:, :, 1::2, None]
        return [torch.cat([w1[:, :, i], w2[:, :, i]], -1) for i in range(nb)]

    def filter_context(self, kw, dist, edge_type, edge_mask):
        """What every block's filters share: the stacked filters, or
        nothing."""
        if self.stacked is None:
            return None
        return self.stacked_filters(kw["e_packed"], kw["we"])

    def block_aggregates(self, k, blk, h, kw, ctx):
        """Block k's two aggregates (B, N, F) f32, the node tail's inputs."""
        c1, c2 = blk["convs"]
        pairs = kw["pairs"]
        if ctx is not None:
            x = torch.cat([node_input(c1, h), node_input(c2, h)], -1)
            a = endpoint_sum(ctx[k], x, pairs)
            f1 = c1["fb"][0].shape[1]
            return a[..., :f1], a[..., f1:]
        return tuple(self.cf_pathway(conv, h, kw["e_packed"],
                                     kw["we"][2 * k + s], pairs)
                     for s, conv in enumerate((c1, c2)))

    def cf_pathway(self, conv, h, e, we_k, pairs):
        """One conv's aggregate (fast_forward.py:463-486 of the JAX
        package): under store_dtype the filter stored narrow and read
        back at the compute dtype, times the distance weight at the
        compute dtype; the messages' products and sums in f32."""
        x = node_input(conv, h)
        wp = self.filter(conv, e)
        sdt, cd = self.store_dtype, self.compute_dtype
        if sdt is None:
            return endpoint_sum(wp * we_k[..., None], x, pairs)
        t = store(wp, sdt, cd) * we_k.to(cd)[..., None]
        return endpoint_sum(t.float(), x.to(cd).float(), pairs)

    @torch.no_grad()
    def __call__(self, batch, pairs: Optional[PairList] = None, *,
                 extend_order: bool = False, extend_radius: bool = True
                 ) -> ModelOutput:
        self.calls += 1
        kw, (edge_mask, edge_type, local_mask, dist) = self.stack_inputs(
            batch, pairs, extend_order=extend_order,
            extend_radius=extend_radius)
        pairs, cd = kw["pairs"], self.compute_dtype
        ctx = self.filter_context(kw, dist, edge_type, edge_mask)
        h = kw["h0"]
        for k, blk in enumerate(self.blocks):
            a1, a2 = self.block_aggregates(k, blk, h, kw, ctx)
            h = schnet_block(blk, h, a1, a2, self.softplus, self.sigmoid)
        e_local = kw["e_packed_local"]
        if self.store_dtype is not None:
            e_local = store(e_local, self.store_dtype, cd)
        hl = gin_tail(self.gin_layers, kw["hl0"], e_local,
                      kw["local_mask_p"], pairs, cd)
        sg = pair_scores(self.stack.grad_global, h, kw["e_packed"], pairs,
                         self.act, cd)
        sl = pair_scores(self.stack.grad_local, hl, kw["e_packed_local"],
                         pairs, self.act, cd)
        return mirrored_output(sg, sl, pairs, edge_mask, edge_type,
                               local_mask, dist)


def stacked_filter_params(blocks) -> Dict:
    """The filter weights of every conv stacked for `stacked_filters`:
    first layers side by side (offsets `offs`), second layers of the
    conv1s and of the conv2s each as one (NB, in, out) tensor."""
    convs = [conv for blk in blocks for conv in blk["convs"]]
    widths = [conv["fa"][0].shape[1] for conv in convs]
    return dict(
        fa_k=torch.cat([c["fa"][0] for c in convs], 1),
        fa_b=torch.cat([c["fa"][1] for c in convs]),
        beta=torch.cat([c["beta"].reshape(1).expand(w)
                        for c, w in zip(convs, widths)]),
        offs=[0] + list(np.cumsum(widths)),
        fb1_k=torch.stack([b["convs"][0]["fb"][0] for b in blocks]),
        fb1_b=torch.stack([b["convs"][0]["fb"][1] for b in blocks]),
        fb2_k=torch.stack([b["convs"][1]["fb"][0] for b in blocks]),
        fb2_b=torch.stack([b["convs"][1]["fb"][1] for b in blocks]),
    )


class PallasForward(FastForward):
    """Engine 'pallas' (fast_forward.py:574-580, :737-781 of the JAX
    package): the dense (B, N, N, C) layout at the config's compute dtype.
    The edge features run through the encoder on the triu pairs and are
    mirrored to dense (pack_pairs, the default), or through it on all N^2
    ordered pairs, the diagonal included (pack_pairs=False). Each
    interaction block is one K3 launch on the dense features and distance-
    weight planes, then its node tail; the GIN layers aggregate through K5
    at f32 and through an f32 einsum at bf16 (:753-764); the score heads
    run on the packed pairs with f32 weights on bf16-rounded inputs, or,
    with pack_pairs=False, through K4 with weights at the compute dtype
    (:523-531)."""

    cast_heads = False

    def __init__(self, config: ModelConfig, model: DualEncoderEpsNetwork,
                 *, compute_dtype: torch.dtype = torch.float32,
                 pack_pairs: bool = True):
        super().__init__(config, model, compute_dtype=compute_dtype)
        self.mode, self.pack_pairs = "dense", pack_pairs
        cd = compute_dtype
        # K4's weights at the compute dtype, biases f32 (:526-529)
        self.dense_heads = [
            tuple(w.to(cd).contiguous() if k % 2 == 0 else w.contiguous()
                  for k, w in enumerate(p6))
            for p6 in (self.stack.grad_global, self.stack.grad_local)]

    def encode_edges(self, dist, edge_type, pairs):
        """(e_packed, e_packed_local) on the pair list (None without
        pack_pairs) and the dense (B, N, N, C) features of both branches,
        at the compute dtype."""
        cd = self.compute_dtype
        if self.pack_pairs:
            el = pack_plane(dist, pairs)[..., None]
            tp = pack_plane(edge_type, pairs)
        else:
            el, tp = dist[..., None], edge_type
        e = edge_encode(self.ee, el, tp, self.gelu).to(cd)
        e_local = (e if self.ee_local is None else
                   edge_encode(self.ee_local, el, tp, self.gelu).to(cd))
        if not self.pack_pairs:
            return None, None, e, e_local
        dense = mirror_features(e, pairs)
        dense_local = (dense if self.ee_local is None
                       else mirror_features(e_local, pairs))
        return e, e_local, dense, dense_local

    @torch.no_grad()
    def __call__(self, batch, pairs: Optional[PairList] = None, *,
                 extend_order: bool = False, extend_radius: bool = True
                 ) -> ModelOutput:
        self.calls += 1
        cfg, cd = self.config, self.compute_dtype
        if self.pack_pairs and pairs is None:
            pairs = self.prepare(batch)
        dist, edge_mask, edge_type, local_mask = working_graph(
            batch, cfg.cutoff, cfg.edge_order, extend_order=extend_order,
            extend_radius=extend_radius)
        e_p, e_pl, edge_attr, edge_attr_local = self.encode_edges(
            dist, edge_type, pairs)
        b, n = dist.shape[:2]
        env = envelope(dist, cfg.cutoff, cfg.smooth_conv) * edge_mask
        we = stacked_distance_weights(
            self.blocks, dist.reshape(b, n * n, 1), env.reshape(b, n * n),
            self.sigmoid).reshape(-1, b, n, n)
        h = embed_max_norm(self.schnet_emb, batch.atom_type,
                           cfg.embedding_max_norm).float()
        for k, blk in enumerate(self.blocks):
            c1, c2 = blk["convs"]
            a1, a2 = interaction_block_aggregate(
                edge_attr, we[2 * k], we[2 * k + 1], node_input(c1, h),
                node_input(c2, h), c1, c2)
            h = schnet_block(blk, h, a1, a2, self.softplus, self.sigmoid)
        sg = self.scores(0, h, e_p, edge_attr, edge_mask, pairs)
        hl = self.gin_emb[batch.atom_type]
        for i, layer in enumerate(self.gin_layers):
            if cd == torch.float32:
                agg = gine_aggregate(hl, edge_attr_local, local_mask)
            else:
                msg = torch.relu(hl[:, None] + edge_attr_local.float())
                agg = torch.einsum("bij,bijh->bih", local_mask.float(), msg)
            hl = gin_layer(layer, hl, agg, i == len(self.gin_layers) - 1)
        sl = self.scores(1, hl, e_pl, edge_attr_local, local_mask, pairs)
        return ModelOutput(
            edge_inv_global=sg, edge_inv_local=sl, edge_mask=edge_mask,
            edge_type=edge_type, edge_length=dist, local_mask=local_mask)

    def scores(self, head, h, e_packed, edge_attr, mask, pairs):
        """Score head 0 (global) or 1 (local) as a dense (B, N, N) plane,
        zero off the mask."""
        cd = self.compute_dtype
        if not self.pack_pairs:
            return pair_score_mlp(h.to(cd), edge_attr, mask,
                                  *self.dense_heads[head],
                                  activation=self.config.mlp_act)
        p6 = (self.stack.grad_global, self.stack.grad_local)[head]
        s = pair_scores(p6, h, e_packed, pairs, self.act, cd,
                        wd=torch.float32)
        return torch.where(mask, mirror_plane(s, pairs),
                           torch.zeros((), device=s.device))


def build_fast_forward(config: ModelConfig, model: DualEncoderEpsNetwork,
                       engine: Optional[str] = None,
                       pack_pairs: bool = True) -> FastForward:
    """The forward of a triu engine (ENGINES): None and 'approx' run f32,
    'stack' f32, the kernel and slim engines bf16, 'pallas' the config's
    dtype. pack_pairs=False (engine 'pallas' only) runs the edge encoder
    and the score heads on all N^2 ordered pairs, the heads through K4."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES}")
    opts = engine_options(engine)
    if opts.mode == "dense":
        cd = (torch.bfloat16 if config.dtype == "bfloat16"
              else torch.float32)
        return PallasForward(config, model, compute_dtype=cd,
                             pack_pairs=pack_pairs)
    if not pack_pairs:
        raise ValueError("pack_pairs=False is an option of engine 'pallas'")
    if opts.mode in ("xla", "stack"):
        cd = torch.float32 if opts.store is None else torch.bfloat16
        return XlaForward(config, model, compute_dtype=cd,
                          store_dtype=opts.store,
                          stack=opts.mode == "stack", approx=opts.approx,
                          edge_dtype=opts.edge)
    cd = torch.float32 if opts.mode is None else torch.bfloat16
    return FastForward(config, model, mode=opts.mode, compute_dtype=cd,
                       approx=opts.approx, edge_dtype=opts.edge)
