"""Global SchNet-style encoder, dense masked form (port of
agdiff_tpu/nn/schnet.py). With `pairs` (a shared triu PairList, the
`packed_pairs` train layout) the per-edge tensors are (B, P[, C]) on the
unordered pairs and the aggregation runs over endpoint selectors
(agdiff_tpu/nn/schnet.py:100-108); with a rank's OwnedPairs (packed under
a node layout, ops/pairs.py) h_i comes from the rank's rows, h_j from the
gathered axis, and both sides' messages reach their rows through one
reduce-scatter a CFConv. Under a node layout `nodes`
(parallel/mesh.py NodeLayout, mode 'sp') the nodes are this rank's rows
and the per-edge tensors their row blocks (B, k, N, C): each CFConv
gathers the whole axis of h after norm1 for the j side. `dtype` is the
compute dtype of every layer and of the embedding's output
(nn/common.py); the learnable softplus turns a bf16 input into f32, as
the JAX module's f32 beta does."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from agdiff_torch.nn.common import Linear, MaskedBatchNorm, ShiftedSoftplus
from agdiff_torch.ops.pairs import gather_endpoints, scatter_add_endpoints


def envelope(d, cutoff: float, smooth: bool):
    """CFConv cutoff envelope: cosine (smooth) or Gaussian, zero past the
    cutoff."""
    if smooth:
        env = 0.5 * (torch.cos(d * math.pi / cutoff) + 1.0)
        env = env * (d <= cutoff)
    else:
        env = torch.exp(-((d - cutoff) ** 2) / (2 * cutoff ** 2))
    return env * (d <= cutoff) * (d >= 0.0)


class DistanceWeightingNetwork(nn.Module):
    """Per-edge scalar weight sigmoid(W2 relu(W1 d))."""

    def __init__(self, hidden_dim: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer1 = Linear(1, hidden_dim, dtype=dtype)
        self.layer2 = Linear(hidden_dim, 1, dtype=dtype)

    def forward(self, edge_length):
        return torch.sigmoid(self.layer2(torch.relu(self.layer1(edge_length))))


class CFConv(nn.Module):
    """Continuous-filter convolution over the dense working graph."""

    def __init__(self, hidden: int, num_filters: int, cutoff: float,
                 smooth: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cutoff, self.smooth = cutoff, smooth
        self.distance_weighting = DistanceWeightingNetwork(dtype=dtype)
        self.filter_0 = Linear(hidden, num_filters, dtype=dtype)
        self.filter_act = ShiftedSoftplus()
        self.filter_1 = Linear(num_filters, num_filters, dtype=dtype)
        self.lin1 = Linear(hidden, num_filters, dtype=dtype)
        self.norm1 = MaskedBatchNorm(num_filters)
        self.lin2 = Linear(num_filters, hidden, dtype=dtype)
        self.norm2 = MaskedBatchNorm(hidden)

    def forward(self, x, node_mask, edge_mask, edge_length, edge_attr,
                train: bool = False, pairs=None, nodes=None):
        combined = (self.distance_weighting(edge_length)
                    * envelope(edge_length, self.cutoff, self.smooth))
        w = self.filter_1(self.filter_act(self.filter_0(edge_attr)))
        w = w * combined
        h = torch.nn.functional.leaky_relu(
            self.norm1(self.lin1(x), node_mask, train), 0.2)
        w = torch.where(edge_mask[..., None], w, torch.zeros_like(w))
        if pairs is not None:
            hi, hj = gather_endpoints(h, pairs)
            out = scatter_add_endpoints(w * hj, w * hi, pairs)
        else:
            hj = h if nodes is None else nodes.gather(h)
            out = torch.einsum("bijf,bjf->bif", w, hj)
        return self.norm2(self.lin2(out), node_mask, train)


class InteractionBlock(nn.Module):
    """Two CFConvs (filter widths F and F/2) -> concat -> shifted softplus
    -> Linear(2H -> H) -> relu/sigmoid attention gate."""

    def __init__(self, hidden: int, num_filters: int, cutoff: float,
                 smooth: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = CFConv(hidden, num_filters, cutoff, smooth, dtype)
        self.conv2 = CFConv(hidden, num_filters // 2, cutoff, smooth, dtype)
        self.act = ShiftedSoftplus()
        self.lin = Linear(2 * hidden, hidden, dtype=dtype)
        self.attention_0 = Linear(hidden, hidden // 2, dtype=dtype)
        self.attention_1 = Linear(hidden // 2, 1, dtype=dtype)

    def forward(self, x, node_mask, edge_mask, edge_length, edge_attr,
                train: bool = False, pairs=None, nodes=None):
        p1 = self.conv1(x, node_mask, edge_mask, edge_length, edge_attr,
                        train, pairs, nodes)
        p2 = self.conv2(x, node_mask, edge_mask, edge_length, edge_attr,
                        train, pairs, nodes)
        combined = self.lin(self.act(torch.cat([p1, p2], dim=-1)))
        gate = torch.sigmoid(self.attention_1(
            torch.relu(self.attention_0(combined))))
        return combined * gate


class AdaptiveScalingModule(nn.Module):
    """Per-node squeeze-and-excitation gate x * sigmoid(W2 relu(W1 x))."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc_0 = Linear(channels, channels // reduction, bias=False,
                           dtype=dtype)
        self.fc_1 = Linear(channels // reduction, channels, bias=False,
                           dtype=dtype)

    def forward(self, x):
        return x * torch.sigmoid(self.fc_1(torch.relu(self.fc_0(x))))


def embed_max_norm(table, ids, max_norm: Optional[float],
                   dtype: torch.dtype = torch.float32):
    """Embedding lookup with torch's max_norm renormalisation applied at
    lookup (functionally; the table is not modified), on the rows cast to
    `dtype`."""
    e = torch.nn.functional.embedding(ids, table).to(dtype)
    if max_norm is not None:
        norm = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
        e = e * torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return e


class SchNetEncoder(nn.Module):
    def __init__(self, hidden: int = 128, num_interactions: int = 6,
                 cutoff: float = 10.0, smooth: bool = False,
                 embedding_max_norm: Optional[float] = 10.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_interactions = num_interactions
        self.embedding_max_norm = embedding_max_norm
        self.compute_dtype = dtype
        self.embedding = nn.Embedding(100, hidden)
        for i in range(num_interactions):
            self.add_module(f"interactions_{i}", InteractionBlock(
                hidden, hidden, cutoff, smooth, dtype))
            self.add_module(f"scaling_modules_{i}",
                            AdaptiveScalingModule(hidden, dtype=dtype))

    def forward(self, z, node_mask, edge_mask, edge_length, edge_attr,
                train: bool = False, pairs=None, nodes=None):
        h = embed_max_norm(self.embedding.weight, z, self.embedding_max_norm,
                           self.compute_dtype)
        for i in range(self.num_interactions):
            out = getattr(self, f"interactions_{i}")(
                h, node_mask, edge_mask, edge_length, edge_attr, train, pairs,
                nodes)
            h = h + getattr(self, f"scaling_modules_{i}")(out)
        return h
