"""MLPEdgeEncoder (port of agdiff_tpu/nn/edge_encoders.py).

GELU(Linear(1 -> H)) expansion of the edge length, a bond-type embedding
(100, H), concat -> 2-layer MLP, concat with the bond embedding again ->
2-layer MLP, then the reference's "attention": a softmax over a singleton
axis, which is exactly 1 (computed here for parity; the fast forward skips
it, as the JAX engines do). At `dtype` bf16 the length expansion, the
bond embedding and every layer after them run at bf16
(agdiff_tpu/nn/edge_encoders.py:48-80).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from agdiff_torch.nn.common import Linear, gelu


class MLPEdgeEncoder(nn.Module):
    def __init__(self, hidden_dim: int = 128,
                 attention_mode: str = "softmax_dim1",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if attention_mode not in ("softmax_dim1", "none"):
            raise ValueError(f"unsupported attention_mode {attention_mode!r}")
        h = hidden_dim
        self.attention_mode = attention_mode
        self.compute_dtype = dtype
        self.feature_expansion = Linear(1, h, dtype=dtype)
        self.bond_emb = nn.Embedding(100, h)
        self.edge_feature_mlp_0 = Linear(2 * h, h, dtype=dtype)
        self.edge_feature_mlp_1 = Linear(h, h, dtype=dtype)
        self.combination_mlp_0 = Linear(2 * h, h, dtype=dtype)
        self.combination_mlp_1 = Linear(h, h, dtype=dtype)
        if attention_mode == "softmax_dim1":
            self.attention_0 = Linear(h, h, dtype=dtype)
            self.attention_1 = Linear(h, 1, dtype=dtype)

    def forward(self, edge_length, edge_type):
        expanded = gelu(self.feature_expansion(edge_length))
        # F.embedding: its backward sums a row's many uses by segments,
        # where indexing's backward serialises them (training's largest
        # cost on a card)
        bond = F.embedding(edge_type, self.bond_emb.weight).to(self.compute_dtype)
        x = gelu(self.edge_feature_mlp_0(torch.cat([expanded, bond], -1)))
        x = self.edge_feature_mlp_1(x)
        y = gelu(self.combination_mlp_0(torch.cat([x, bond], -1)))
        edge_attr = self.combination_mlp_1(y)
        if self.attention_mode == "none":
            return edge_attr
        logits = self.attention_1(torch.tanh(self.attention_0(edge_attr)))
        return edge_attr * torch.softmax(logits, dim=-1)
