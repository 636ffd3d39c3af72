"""Dense working-graph construction (port of agdiff_tpu/ops/graph.py).

`working_graph` is the one mask helper of every forward of the port: the
optional in-forward bond-order extension of a raw adjacency
(`extend_order`), the pairwise distances, and either the union of the
radius graph with the bond graph (`extend_radius=True`, the reference's
test-time setting) or the bond graph alone (agdiff_tpu/models/dualenc.py:
86-95, ops/pallas/monolithic.py:415-428).
"""

from __future__ import annotations

import torch

from agdiff_torch.chem.constants import NUM_BOND_TYPES
from agdiff_torch.ops.geometry import pairwise_distance


def radius_union_mask(dist, bond_adj, node_mask, cutoff: float):
    """Union of the radius graph and the typed bond graph.

    Returns edge_mask (B, N, N) bool, edge_type (B, N, N) int64 (0 for
    radius-only edges) and local_mask (B, N, N) bool (bond-graph edges).
    """
    pair = _real_pairs(node_mask)
    local_mask = (bond_adj > 0) & pair
    edge_mask = ((dist <= cutoff) & pair) | local_mask
    edge_type = torch.where(edge_mask, bond_adj, torch.zeros_like(bond_adj))
    return edge_mask, edge_type, local_mask


def bond_graph_mask(bond_adj, node_mask):
    """The bond graph alone (extend_radius=False): edge_mask equals
    local_mask, and edge_type is the adjacency on it."""
    local_mask = (bond_adj > 0) & _real_pairs(node_mask)
    edge_type = torch.where(local_mask, bond_adj, torch.zeros_like(bond_adj))
    return local_mask, edge_type, local_mask


def _real_pairs(node_mask):
    n = node_mask.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=node_mask.device)
    return node_mask[:, :, None] & node_mask[:, None, :] & ~eye[None]


def extend_graph_order_dense(bond_adj, order: int = 3,
                             num_types: int = NUM_BOND_TYPES):
    """In-forward dense bond-order extension (agdiff_tpu/ops/graph.py:
    60-82; the host version is data/transforms.extend_bond_order).
    bond_adj (..., N, N) int typed adjacency (0: none); returns the same
    shape with k-hop edges (2 <= k <= order) typed num_types + k - 1, as
    int64."""
    adj = (bond_adj > 0).long()
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=torch.long, device=adj.device)
    one_hop = ((adj + eye) > 0).long()
    reach = one_hop.expand(adj.shape)
    hop = reach - eye
    for k in range(2, order + 1):
        # path counts are small integers, exact in f32 (CUDA has no
        # integer matmul)
        nxt = (torch.matmul(reach.float(), one_hop.float()) > 0).long()
        hop = hop + (nxt - reach) * k
        reach = nxt
    high = torch.where(hop > 1, num_types + hop - 1, torch.zeros_like(hop))
    return torch.where(hop == 1, bond_adj.long(), high)


def working_graph(batch, cutoff: float, edge_order: int, *,
                  extend_order: bool = False, extend_radius: bool = True,
                  dtype: torch.dtype = torch.float32):
    """(dist, edge_mask, edge_type, local_mask) of a GraphBatch: the bond
    adjacency extended to `edge_order` here when extend_order (it is
    normally extended on the host), then the radius union or the bond
    graph alone. The distances are taken on the positions cast to
    `dtype` (the module's compute dtype), and the radius mask on them."""
    bond_adj = batch.bond_adj
    if extend_order:
        bond_adj = extend_graph_order_dense(bond_adj, order=edge_order)
    dist = pairwise_distance(batch.pos.to(dtype))
    if extend_radius:
        masks = radius_union_mask(dist, bond_adj, batch.node_mask, cutoff)
    else:
        masks = bond_graph_mask(bond_adj, batch.node_mask)
    return (dist,) + masks
