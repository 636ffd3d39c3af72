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
* the suffix '-approx' on a kernel engine swaps softplus, sigmoid and
  gelu for ops/approx.py's forms, in the edge encoder, the distance
  weights and inside K1 (sampling/langevin.py:388-394 of the JAX package).

On a card K1 is the hand-written CUDA kernel; CPU tensors take its plain
version.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from agdiff_torch.config import ModelConfig
from agdiff_torch.kernels.stack_packed import (
    StackParams,
    packed_stack_forward,
    packed_stack_forward_plain,
)
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork, ModelOutput
from agdiff_torch.nn.common import activation_by_name, gelu
from agdiff_torch.nn.schnet import embed_max_norm, envelope
from agdiff_torch.ops import approx as ax
from agdiff_torch.ops.geometry import pairwise_distance
from agdiff_torch.ops.graph import radius_union_mask
from agdiff_torch.ops.pairs import (
    PairList,
    gather_nodes,
    mirror_plane,
    pack_plane,
    scatter_nodes,
    triu_pairs,
)

KERNEL_MODES = {"pks": "schnet", "pksg": "gin", "pksf": "full"}
ENGINES = (None,) + tuple(f"{k}{s}" for k in KERNEL_MODES
                          for s in ("", "-approx"))


def engine_options(engine: Optional[str]):
    """(tight, K1 mode, approx) of an engine name: [tight-]pks|pksg|pksf
    [-approx], 'tight' or None (the plain f32 forward)."""
    name = engine or ""
    approx = name.endswith("-approx")
    name = name[:-len("-approx")] if approx else name
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


def pair_scores(p6, h, e, pairs: PairList, act, cd):
    """A pair-score head on the list: MLP3(concat(h_i * h_j, e)) -> (B, P)
    f32 (tight_forward.py:355-378, fast_forward.py:488-521 of the JAX
    package). At bf16 (slim storage) every product outputs bf16 and the
    last layer sums in f32; at f32 everything is f32."""
    w1, b1, w2, b2, w3, b3 = p6
    c = h.shape[-1]
    hb = h.to(cd)
    prod = gather_nodes(hb, pairs.iu) * gather_nodes(hb, pairs.ju)
    x = act(prod @ w1[:c].to(cd) + e.to(cd) @ w1[c:].to(cd) + b1.to(cd))
    y = act(x @ w2.to(cd) + b2.to(cd))
    return (y.float() @ w3.to(cd).float() + b3.float())[..., 0]


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
        out = torch.relu((hl + agg) @ layer["l0"][0] + layer["l0"][1])
        out = out @ layer["l1"][0] + layer["l1"][1]
        if i < len(layers) - 1:
            out = torch.relu(out)
        hl = out + hl
    return hl


class FastForward:
    """forward(batch, pairs=None) -> ModelOutput over the bucket's triu
    pair set. mode None runs K1's plain version in mode 'full' (the f32
    engine); a K1 mode runs K1 through its wrapper and the remaining
    layers in plain PyTorch. compute_dtype bf16 narrows the filter weights
    and products as the JAX slim engines do."""

    cast_heads = True   # slim storage: score heads in bf16 before K1

    def __init__(self, config: ModelConfig, model: DualEncoderEpsNetwork,
                 *, mode: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 approx: bool = False):
        if mode is not None and mode not in KERNEL_MODES.values():
            raise ValueError(f"K1 mode {mode!r}")
        self.config = config
        self.mode, self.approx = mode, approx
        cd = self.compute_dtype = compute_dtype
        self.act = activation_by_name(config.mlp_act)
        self.gelu = ax.gelu if approx else gelu
        self.sigmoid = ax.sigmoid if approx else torch.sigmoid
        folded = fold_eval_params(model)
        self.ee, self.ee_local = folded["ee"], folded["ee_local"]
        self.blocks = folded["blocks"]
        self.schnet_emb, self.gin_emb = folded["schnet_emb"], folded["gin_emb"]
        self.gin_layers = folded["gin_layers"]
        grad_global, grad_local = folded["grad_global"], folded["grad_local"]
        if cd == torch.bfloat16:
            # slim storage: filter weights (and score heads) at bf16
            for blk in self.blocks:
                for conv in blk["convs"]:
                    conv["fa"] = (conv["fa"][0].to(cd), conv["fa"][1])
                    conv["fb"] = (conv["fb"][0].to(cd), conv["fb"][1])
            if self.cast_heads:
                grad_global = tuple(p.to(cd) for p in grad_global)
                grad_local = tuple(p.to(cd) for p in grad_local)
        self.stack = StackParams(self.blocks, self.gin_layers, grad_global,
                                 grad_local, act=config.mlp_act)
        self._pairs: Dict[tuple, PairList] = {}
        self.calls = 0  # forwards run (chip_smoke.py checks K1's launches)

    def prepare(self, batch, capacity: Optional[int] = None) -> PairList:
        """The pair list of this batch's bucket (built once per size)."""
        n, dev = batch.atom_type.shape[1], batch.atom_type.device
        key = (n, str(dev))
        if key not in self._pairs:
            self._pairs[key] = triu_pairs(n, dev)
        return self._pairs[key]

    @torch.no_grad()
    def stack_inputs(self, batch, pairs: Optional[PairList] = None):
        """Everything before K1: the working graph, the packed edge
        features and planes (zero at pad slots), the initial node states.
        Returns K1's keyword arguments and the dense masks (edge_mask,
        edge_type, local_mask, dist)."""
        cfg, cd = self.config, self.compute_dtype
        pairs = pairs if pairs is not None else self.prepare(batch)
        dist = pairwise_distance(batch.pos)
        edge_mask, edge_type, local_mask = radius_union_mask(
            dist, batch.bond_adj, batch.node_mask, cfg.cutoff)
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
    def __call__(self, batch, pairs: Optional[PairList] = None
                 ) -> ModelOutput:
        self.calls += 1
        kw, (edge_mask, edge_type, local_mask, dist) = \
            self.stack_inputs(batch, pairs)
        pairs, cd = kw["pairs"], self.compute_dtype
        if self.mode is None:
            sg, sl = packed_stack_forward_plain(**kw)
        else:
            res = packed_stack_forward(**kw, mode=self.mode,
                                       approx=self.approx)
            if self.mode == "full":
                sg, sl = res
            else:
                h, hl = (res, None) if self.mode == "schnet" else res
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


def build_fast_forward(config: ModelConfig, model: DualEncoderEpsNetwork,
                       engine: Optional[str] = None) -> FastForward:
    """The forward of a triu engine (ENGINES): None runs f32, the kernel
    engines bf16."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES}")
    _, mode, approx = engine_options(engine)
    cd = torch.float32 if mode is None else torch.bfloat16
    return FastForward(config, model, mode=mode, compute_dtype=cd,
                       approx=approx)
