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


def radius_union_mask(dist, bond_adj, node_mask, cutoff: float,
                      nodes=None):
    """Union of the radius graph and the typed bond graph.

    Returns edge_mask (B, N, N) bool, edge_type (B, N, N) int64 (0 for
    radius-only edges) and local_mask (B, N, N) bool (bond-graph edges);
    under a node layout, their row blocks (B, k, N).
    """
    pair = _real_pairs(node_mask, nodes)
    local_mask = (bond_adj > 0) & pair
    edge_mask = ((dist <= cutoff) & pair) | local_mask
    edge_type = torch.where(edge_mask, bond_adj, torch.zeros_like(bond_adj))
    return edge_mask, edge_type, local_mask


def bond_graph_mask(bond_adj, node_mask, nodes=None):
    """The bond graph alone (extend_radius=False): edge_mask equals
    local_mask, and edge_type is the adjacency on it."""
    local_mask = (bond_adj > 0) & _real_pairs(node_mask, nodes)
    edge_type = torch.where(local_mask, bond_adj, torch.zeros_like(bond_adj))
    return local_mask, edge_type, local_mask


def _real_pairs(node_mask, nodes=None):
    """(B, N, N) pairs of distinct real nodes; under a node layout
    (parallel/mesh.py NodeLayout) the rows of this rank's nodes against
    the whole axis (the j-side mask gathered)."""
    cols = node_mask if nodes is None else nodes.gather(node_mask)
    n = cols.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=node_mask.device)
    if nodes is not None:
        eye = eye[nodes.rows]
    return node_mask[:, :, None] & cols[:, None, :] & ~eye[None]


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
                  dtype: torch.dtype = torch.float32, nodes=None):
    """(dist, edge_mask, edge_type, local_mask) of a GraphBatch: the bond
    adjacency extended to `edge_order` here when extend_order (it is
    normally extended on the host), then the radius union or the bond
    graph alone. The distances are taken on the positions cast to
    `dtype` (the module's compute dtype), and the radius mask on them.

    Under a node layout `nodes` (parallel/mesh.py NodeLayout) the batch
    holds this rank's node rows (pos (B, k, 3), bond_adj (B, k, N)) and
    the four planes come out as row blocks (B, k, N), the distances to
    the gathered positions; the in-forward extension, which needs the
    whole adjacency, is refused."""
    bond_adj = batch.bond_adj
    if extend_order:
        if nodes is not None:
            raise ValueError("extend_order needs the whole adjacency: "
                             "extend it on the host under a node layout")
        bond_adj = extend_graph_order_dense(bond_adj, order=edge_order)
    pos = batch.pos.to(dtype)
    dist = pairwise_distance(
        pos, None if nodes is None else nodes.gather(pos))
    if extend_radius:
        masks = radius_union_mask(dist, bond_adj, batch.node_mask, cutoff,
                                  nodes)
    else:
        masks = bond_graph_mask(bond_adj, batch.node_mask, nodes)
    return (dist,) + masks
