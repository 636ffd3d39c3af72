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
  weights and inside the kernels (sampling/langevin.py:388-394 of the JAX
  package);
* 'pallas' (`PallasForward`, the config's dtype; fast_forward.py:574-580,
  :753-758 of the JAX package): the dense (B, N, N, C) layout, one K3
  launch per interaction block (kernels/fused.py), the GIN layers through
  K5 at f32 and an f32 einsum at bf16, and the score heads on the packed
  pairs; with pack_pairs=False the edge encoder runs over all N^2 ordered
  pairs and both heads go through K4. It has no '-approx' form, as in the
  JAX package (:303-304).

On a card each kernel is the hand-written CUDA kernel; CPU tensors take
its plain version.
"""

from __future__ import annotations

from typing import Dict, Optional

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
    packed_stack_forward,
    packed_stack_forward_plain,
)
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork, ModelOutput
from agdiff_torch.nn.common import LN2, activation_by_name, gelu
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
ENGINES = (None, "pallas") + tuple(f"{k}{s}" for k in KERNEL_MODES
                                   for s in ("", "-approx"))


def engine_options(engine: Optional[str]):
    """(tight, mode, approx) of an engine name: [tight-]pks|pksg|pksf
    [-approx], pk[-approx], 'pallas', 'tight' or None (the plain f32
    forward)."""
    name = engine or ""
    approx = name.endswith("-approx")
    name = name[:-len("-approx")] if approx else name
    if name == "pallas":
        if approx:
            # agdiff_tpu/models/fast_forward.py:303-304
            raise ValueError("approx engines use the XLA path "
                             "(use_pallas=False); 'pallas' has no "
                             "'-approx' form")
        return False, "dense", False
    tight = name == "tight" or name.startswith("tight-")
    name = name[len("tight-"):] if name.startswith("tight-") else (
        "" if name == "tight" else name)
    if name in KERNEL_MODES:
        return tight, KERNEL_MODES[name], approx
    if name == "" and not approx:
        return tight, None, False
    raise ValueError(f"unknown engine {engine!r}")


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


def edge_encode(ee, edge_length, edge_type, act=gelu):
    """MLPEdgeEncoder minus the identity softmax attention; the length
    expansion is elementwise (its Linear has one input)."""
    k, b = _linear(ee.feature_expansion)
    expanded = act(edge_length * k[0] + b)
    bond = ee.bond_emb.weight.detach()[edge_type]
    k, b = _linear(ee.edge_feature_mlp_0)
    x = act(torch.cat([expanded, bond], dim=-1) @ k + b)
    k, b = _linear(ee.edge_feature_mlp_1)
    x = x @ k + b
    y = torch.cat([x, bond], dim=-1)
    k, b = _linear(ee.combination_mlp_0)
    y = act(y @ k + b)
    k, b = _linear(ee.combination_mlp_1)
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


class FastForward:
    """forward(batch, pairs=None) -> ModelOutput over the bucket's triu
    pair set. mode None runs K1's plain version in mode 'full' (the f32
    engine); a K1 mode runs K1 through its wrapper, mode 'blocks' K2 once
    per interaction block, and the remaining layers run in plain PyTorch.
    compute_dtype bf16 narrows the filter weights and products as the JAX
    slim engines do."""

    cast_heads = True   # slim storage: score heads in bf16 before K1

    def __init__(self, config: ModelConfig, model: DualEncoderEpsNetwork,
                 *, mode: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 approx: bool = False):
        if mode is not None and mode not in KERNEL_MODES.values():
            raise ValueError(f"mode {mode!r}")
        self.config = config
        self.mode, self.approx = mode, approx
        cd = self.compute_dtype = compute_dtype
        self.act = activation_by_name(config.mlp_act)
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
        e_packed = edge_encode(self.ee, el_packed, type_packed,
                               self.gelu).to(cd)
        e_packed_local = (e_packed if self.ee_local is None else
                          edge_encode(self.ee_local, el_packed, type_packed,
                                      self.gelu).to(cd))
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
            sg, sl = packed_stack_forward_plain(**kw)
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
        zero = torch.zeros((), device=dist.device)
        return ModelOutput(
            edge_inv_global=torch.where(edge_mask, mirror_plane(sg, pairs),
                                        zero),
            edge_inv_local=torch.where(local_mask, mirror_plane(sl, pairs),
                                       zero),
            edge_mask=edge_mask, edge_type=edge_type, edge_length=dist,
            local_mask=local_mask,
        )

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
    """The forward of a triu engine (ENGINES): None runs f32, the kernel
    engines bf16, 'pallas' the config's dtype. pack_pairs=False (engine
    'pallas' only) runs the edge encoder and the score heads on all N^2
    ordered pairs, the heads through K4."""
    _, mode, approx = engine_options(engine)
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES}")
    if mode == "dense":
        cd = (torch.bfloat16 if config.dtype == "bfloat16"
              else torch.float32)
        return PallasForward(config, model, compute_dtype=cd,
                             pack_pairs=pack_pairs)
    if not pack_pairs:
        raise ValueError("pack_pairs=False is an option of engine 'pallas'")
    cd = torch.float32 if mode is None else torch.bfloat16
    return FastForward(config, model, mode=mode, compute_dtype=cd,
                       approx=approx)
