"""Engine 'mono': the whole eval forward as one K6 launch (port of
agdiff_tpu/ops/pallas/monolithic.py:387-526, build_monolithic_forward).

Per call: the working graph (ops/graph.py, with extend_order and
extend_radius), the distances, masks and bond types packed over the
bucket's triu pairs, the SchNet embedding (max-norm renormalised) and the
GIN embedding, both rounded to the compute dtype, then one K6 launch
(kernels/monolithic.py; its plain version for CPU tensors), whose packed
planes are mirrored to dense under where(edge_mask / local_mask). The
triu list depends only on the bucket, so the sampler builds it once per
ladder (`prepare`). The compute dtype is the config's, as in JAX's
build_fast_sampler (sampling/langevin.py:345-347), unless given.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from agdiff_torch.config import ModelConfig
from agdiff_torch.kernels.monolithic import (
    MonoParams,
    mono_forward,
    prepare_weights,
)
from agdiff_torch.models.dualenc import ModelOutput
from agdiff_torch.nn.schnet import embed_max_norm
from agdiff_torch.ops.graph import working_graph
from agdiff_torch.ops.pairs import (
    PairList,
    mirror_plane,
    pack_plane,
    triu_pairs,
)


class MonoForward:
    """forward(batch, pairs=None, *, extend_order=False,
    extend_radius=True) -> ModelOutput through K6."""

    def __init__(self, config: ModelConfig, model,
                 compute_dtype: Optional[torch.dtype] = None):
        cfg = self.config = config
        # monolithic.py:80-84, :396-401
        if cfg.edge_encoder != "mlp":
            raise NotImplementedError("monolithic kernel: mlp edge encoder "
                                      "only")
        if cfg.edge_attention_mode == "sigmoid":
            raise NotImplementedError(
                "monolithic kernel elides the reference's identity softmax; "
                "'sigmoid' needs the module path")
        if compute_dtype is None:
            compute_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                             else torch.float32)
        self.compute_dtype = compute_dtype
        w = prepare_weights(cfg, model, compute_dtype)
        self.schnet_emb = w.pop("schnet_emb")
        self.gin_emb = w.pop("gin_emb")
        self.params = MonoParams(w, cutoff=cfg.cutoff,
                                 smooth=cfg.smooth_conv, act=cfg.mlp_act)
        self._pairs: Dict[tuple, PairList] = {}
        self.calls = 0  # forwards run (chip_smoke.py checks the launches)

    def prepare(self, batch, capacity: Optional[int] = None) -> PairList:
        """The bucket's triu list (built once per size and device; mono
        takes no capacity)."""
        n, dev = batch.atom_type.shape[1], batch.atom_type.device
        key = (n, str(dev))
        if key not in self._pairs:
            self._pairs[key] = triu_pairs(n, dev)
        return self._pairs[key]

    @torch.no_grad()
    def kernel_inputs(self, batch, pairs: Optional[PairList] = None, *,
                      extend_order: bool = False, extend_radius: bool = True):
        """K6's arguments for this batch, and the dense masks (edge_mask,
        edge_type, local_mask, dist)."""
        cfg, cd = self.config, self.compute_dtype
        pairs = pairs if pairs is not None else self.prepare(batch)
        dist, edge_mask, edge_type, local_mask = working_graph(
            batch, cfg.cutoff, cfg.edge_order, extend_order=extend_order,
            extend_radius=extend_radius)
        h0 = embed_max_norm(self.schnet_emb, batch.atom_type,
                            cfg.embedding_max_norm)
        hl0 = self.gin_emb[batch.atom_type]
        kw = dict(
            dp=pack_plane(dist, pairs).float().contiguous(),
            em=pack_plane(edge_mask, pairs).float().contiguous(),
            lm=pack_plane(local_mask, pairs).float().contiguous(),
            tp=pack_plane(edge_type, pairs).to(torch.int32).contiguous(),
            h0=h0.to(cd).float().contiguous(),
            hl0=hl0.to(cd).float().contiguous(),
            params=self.params, pairs=pairs)
        return kw, (edge_mask, edge_type, local_mask, dist)

    @torch.no_grad()
    def __call__(self, batch, pairs: Optional[PairList] = None, *,
                 extend_order: bool = False, extend_radius: bool = True
                 ) -> ModelOutput:
        self.calls += 1
        kw, (edge_mask, edge_type, local_mask, dist) = self.kernel_inputs(
            batch, pairs, extend_order=extend_order,
            extend_radius=extend_radius)
        sg, sl = mono_forward(**kw)
        zero = torch.zeros((), device=dist.device)
        return ModelOutput(
            edge_inv_global=torch.where(edge_mask,
                                        mirror_plane(sg, kw["pairs"]), zero),
            edge_inv_local=torch.where(local_mask,
                                       mirror_plane(sl, kw["pairs"]), zero),
            edge_mask=edge_mask, edge_type=edge_type, edge_length=dist,
            local_mask=local_mask)


def build_monolithic_forward(config: ModelConfig, model,
                             compute_dtype: Optional[torch.dtype] = None
                             ) -> MonoForward:
    """The forward of engine 'mono' at `compute_dtype` (default: the
    config's dtype)."""
    return MonoForward(config, model, compute_dtype)
