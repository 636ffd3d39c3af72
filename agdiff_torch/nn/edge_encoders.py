"""The edge encoders (port of agdiff_tpu/nn/edge_encoders.py), chosen by
`get_edge_encoder` on config.edge_encoder.

MLPEdgeEncoder ('mlp', both reference configs): GELU(Linear(1 -> H))
expansion of the edge length, a bond-type embedding (100, H), concat ->
2-layer MLP, concat with the bond embedding again -> 2-layer MLP, then the
reference's "attention": a softmax over a singleton axis, which is exactly
1 (computed here for parity; the fast forward skips it, as the JAX engines
do). At `dtype` bf16 the length expansion, the
bond embedding and every layer after them run at bf16
(agdiff_tpu/nn/edge_encoders.py:48-80).

GaussianSmearingEdgeEncoder ('gaussian', agdiff_tpu/nn/edge_encoders.py:
132-176): a fixed Gaussian RBF expansion of the edge length (H // 2
Gaussians over [0, 2 cutoff]) beside a bond-type embedding (100, H // 2),
no learned layer but the embedding.
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


class GaussianSmearing(nn.Module):
    """Fixed Gaussian RBF expansion exp(coeff (d - offset_g)^2), the
    offsets evenly over [start, stop] and coeff = -0.5 / spacing^2 in f32
    (agdiff_tpu/nn/edge_encoders.py:81-94). No parameters or buffers: the
    offsets are made where the distances are."""

    def __init__(self, start: float = 0.0, stop: float = 5.0,
                 num_gaussians: int = 50):
        super().__init__()
        self.start, self.stop = start, stop
        self.num_gaussians = num_gaussians

    def forward(self, dist):
        offset = torch.linspace(self.start, self.stop, self.num_gaussians,
                                device=dist.device)
        coeff = -0.5 / (offset[1] - offset[0]) ** 2
        diff = dist - offset      # (..., 1) - (G,) -> (..., G)
        return torch.exp(coeff * diff * diff)


class GaussianSmearingEdgeEncoder(nn.Module):
    """RBF smearing of the edge length beside a bond-type embedding,
    concat -> (..., 2 num_gaussians). As in the JAX module, the length is
    rounded to `dtype` first and the offsets are f32, so the RBF comes out
    f32 (JAX's type promotion); the f32 bond embedding is rounded to
    `dtype`; their concatenation takes the wider type (f32 at bf16, as
    jnp.concatenate promotes)."""

    def __init__(self, num_gaussians: int = 64, cutoff: float = 10.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.rbf = GaussianSmearing(0.0, 2 * cutoff, num_gaussians)
        self.bond_emb = nn.Embedding(100, num_gaussians)

    def forward(self, edge_length, edge_type):
        rbf = self.rbf(edge_length.to(self.compute_dtype).float())
        bond = F.embedding(edge_type, self.bond_emb.weight).to(
            self.compute_dtype)
        return torch.cat([rbf, bond], dim=-1)


def get_edge_encoder(config, dtype: torch.dtype = torch.float32
                     ) -> nn.Module:
    """The edge encoder config.edge_encoder names
    (agdiff_tpu/nn/edge_encoders.py:179-194)."""
    if config.edge_encoder == "mlp":
        return MLPEdgeEncoder(config.hidden_dim, config.edge_attention_mode,
                              dtype=dtype)
    if config.edge_encoder == "gaussian":
        return GaussianSmearingEdgeEncoder(config.hidden_dim // 2,
                                           config.cutoff, dtype=dtype)
    raise ValueError(f"Unknown edge encoder: {config.edge_encoder}")
