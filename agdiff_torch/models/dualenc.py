"""DualEncoderEpsNetwork, dense eval forward (port of
agdiff_tpu/models/dualenc.py).

This module path is the numerical anchor of the port: it runs in float32
whatever `config.dtype` says (the dtype selects the fast engine's compute
type, models/fast_forward.py) and is held against the JAX module's
`apply(..., train=False)` by tests/test_torch_port_model.py. Submodule and
parameter names follow the flax scopes, so models/weights.py maps a JAX
variables tree onto it one to one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from agdiff_torch.config import ModelConfig
from agdiff_torch.data.graph_batch import GraphBatch
from agdiff_torch.nn.edge_encoders import MLPEdgeEncoder
from agdiff_torch.nn.gin import GINEncoder
from agdiff_torch.nn.mlp import MultiLayerPerceptron
from agdiff_torch.nn.schnet import SchNetEncoder
from agdiff_torch.ops.graph import working_graph


class ModelOutput(NamedTuple):
    edge_inv_global: torch.Tensor  # (B, N, N) distance score, global branch
    edge_inv_local: torch.Tensor   # (B, N, N) distance score, local branch
    edge_mask: torch.Tensor        # (B, N, N) bool working-graph edges
    edge_type: torch.Tensor        # (B, N, N) int64
    edge_length: torch.Tensor      # (B, N, N) distances
    local_mask: torch.Tensor       # (B, N, N) bool bond-graph edges


class DualEncoderEpsNetwork(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        if config.edge_encoder != "mlp":
            raise NotImplementedError("the port supports the 'mlp' edge "
                                      "encoder (both reference configs)")
        cfg = self.config = config
        h = cfg.hidden_dim
        self.edge_encoder_global = MLPEdgeEncoder(h, cfg.edge_attention_mode)
        if not cfg.tie_edge_encoders:
            self.edge_encoder_local = MLPEdgeEncoder(
                h, cfg.edge_attention_mode)
        self.encoder_global = SchNetEncoder(
            h, cfg.num_convs, cfg.cutoff, cfg.smooth_conv,
            cfg.embedding_max_norm)
        self.encoder_local = GINEncoder(h, cfg.num_convs_local)
        self.grad_global_dist_mlp = MultiLayerPerceptron(
            2 * h, (h, h // 2, 1), cfg.mlp_act)
        self.grad_local_dist_mlp = MultiLayerPerceptron(
            2 * h, (h, h // 2, 1), cfg.mlp_act)

    def forward(self, batch: GraphBatch, *, extend_order: bool = False,
                extend_radius: bool = True) -> ModelOutput:
        """extend_order extends the bond adjacency here (it is normally
        extended on the host); extend_radius=False takes the bond graph
        alone (agdiff_tpu/models/dualenc.py:66-95)."""
        cfg = self.config
        node_mask = batch.node_mask
        dist, edge_mask, edge_type, local_mask = working_graph(
            batch, cfg.cutoff, cfg.edge_order, extend_order=extend_order,
            extend_radius=extend_radius)
        edge_length = dist[..., None]
        e_global = self.edge_encoder_global(edge_length, edge_type)
        e_local = (e_global if cfg.tie_edge_encoders
                   else self.edge_encoder_local(edge_length, edge_type))

        h = self.encoder_global(batch.atom_type, node_mask, edge_mask,
                                edge_length, e_global)
        inv_global = self.grad_global_dist_mlp(_pair_feature(h, e_global))
        hl = self.encoder_local(batch.atom_type, node_mask, local_mask,
                                e_local)
        inv_local = self.grad_local_dist_mlp(_pair_feature(hl, e_local))
        return ModelOutput(
            edge_inv_global=inv_global[..., 0],
            edge_inv_local=inv_local[..., 0],
            edge_mask=edge_mask, edge_type=edge_type, edge_length=dist,
            local_mask=local_mask,
        )


def _pair_feature(node_attr, edge_attr):
    """concat(h_i * h_j, e_ij) over the dense pair block."""
    prod = node_attr[:, :, None, :] * node_attr[:, None, :, :]
    return torch.cat([prod, edge_attr], dim=-1)
