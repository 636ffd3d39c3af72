"""Local GIN encoder over the bond graph, dense masked form (port of
agdiff_tpu/nn/gin.py). With `pairs` (the `packed_pairs` train layout)
edge_attr is (B, P, H) and local_mask (B, P), and the message act(x_j +
e_p) goes to endpoint i, act(x_i + e_p) to j (agdiff_tpu/nn/gin.py:40-54);
with a rank's OwnedPairs (packed under a node layout, ops/pairs.py) both
go into a (B, N, H) partial, reduce-scattered to the rows once a layer.
Under a node layout `nodes` (parallel/mesh.py NodeLayout) x is this
rank's rows and the messages take x_j from the gathered axis.
`dtype` is the compute dtype of the MLPs and of the embedding's output."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from agdiff_torch.nn.common import MaskedBatchNorm, activation_by_name
from agdiff_torch.nn.mlp import MultiLayerPerceptron
from agdiff_torch.ops.pairs import gather_endpoints, scatter_add_endpoints


class GINEConv(nn.Module):
    """out_i = MLP(x_i + sum_j m_ij act(x_j + e_ij)) (eps fixed at 0)."""

    def __init__(self, hidden: int, activation: str = "relu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = activation_by_name(activation)
        self.nn = MultiLayerPerceptron(hidden, (hidden, hidden), activation,
                                       dtype=dtype)

    def forward(self, x, local_mask, edge_attr, train: bool = False,
                pairs=None, nodes=None):
        if pairs is not None:
            xi, xj = gather_endpoints(x, pairs)
            lm = local_mask[..., None].to(x.dtype)
            agg = scatter_add_endpoints(self.act(xj + edge_attr) * lm,
                                        self.act(xi + edge_attr) * lm, pairs)
        else:
            xj = x if nodes is None else nodes.gather(x)
            msg = self.act(xj[:, None, :, :] + edge_attr)
            agg = torch.einsum("bij,bijh->bih", local_mask.to(msg.dtype),
                               msg)
        return self.nn(x + agg, train)


class GINEncoder(nn.Module):
    """Embedding + GINEConv layers, each followed by masked BatchNorm,
    activation (all but the last) and a residual."""

    def __init__(self, hidden: int, num_convs: int = 3,
                 activation: str = "relu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_convs = num_convs
        self.act = activation_by_name(activation)
        self.compute_dtype = dtype
        self.node_emb = nn.Embedding(100, hidden)
        for i in range(num_convs):
            self.add_module(f"convs_{i}", GINEConv(hidden, activation, dtype))
            self.add_module(f"batch_norms_{i}", MaskedBatchNorm(hidden))

    def forward(self, z, node_mask, local_mask, edge_attr,
                train: bool = False, pairs=None, nodes=None):
        h = F.embedding(z, self.node_emb.weight).to(self.compute_dtype)
        for i in range(self.num_convs):
            hidden = getattr(self, f"convs_{i}")(h, local_mask, edge_attr,
                                                 train, pairs, nodes)
            hidden = getattr(self, f"batch_norms_{i}")(hidden, node_mask,
                                                       train)
            if i < self.num_convs - 1:
                hidden = self.act(hidden)
            h = hidden + h
        return h
