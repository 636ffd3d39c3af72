"""Dense masked geometry ops on (B, N, ...) padded blocks (port of
agdiff_tpu/ops/geometry.py)."""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-12


def pairwise_distance(pos: torch.Tensor,
                      other: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, 3) -> (B, N, N) distances, EPS inside the sqrt (the diagonal
    is sqrt(EPS); callers mask it). With `other` (B, M, 3), the (B, N, M)
    distances from pos's rows to other's (a node layout's row block)."""
    other = pos if other is None else other
    diff = pos[:, :, None, :] - other[:, None, :, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1) + EPS)


def eq_transform_dense(score_d, pos, edge_mask, edge_length, nodes=None):
    """Distance scores (B, N, N) -> equivariant position scores (B, N, 3):
    out_i = sum_j [m_ij s_ij + m_ji s_ji] (r_i - r_j) / d_ij.

    With a node layout (parallel/mesh.py NodeLayout) the planes are this
    rank's row block (B, k, N) and pos its rows (B, k, 3): the rank adds
    its rows' own terms, and the transposed ones, which sit in the other
    ranks' rows, arrive as a column partial: node j gets m_ij s_ij (r_j -
    r_i) / d_ij from each row i, summed over the ranks and scattered to
    j's owner (O(N) traffic, the plane never gathered)."""
    s = torch.where(edge_mask, score_d, torch.zeros_like(score_d))
    if nodes is None:
        w = s + s.transpose(1, 2)
        inv_d = w / torch.clamp(edge_length, min=EPS)
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        return torch.einsum("bij,bijc->bic", inv_d, diff)
    inv_d = s / torch.clamp(edge_length, min=EPS)
    diff = pos[:, :, None, :] - nodes.gather(pos)[:, None, :, :]
    own = torch.einsum("bij,bijc->bic", inv_d, diff)
    return own + nodes.columns(-torch.einsum("bij,bijc->bjc", inv_d, diff))


def center_pos(pos, node_mask):
    """Zero each graph's center of mass over its real nodes."""
    m = node_mask[..., None].to(pos.dtype)
    count = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    com = (pos * m).sum(dim=1, keepdim=True) / count
    return (pos - com) * m


def clip_norm(vec, limit: float):
    """Row-wise L2 norm clip."""
    sq = torch.sum(vec * vec, dim=-1, keepdim=True)
    norm = torch.sqrt(torch.clamp(sq, min=EPS * EPS))
    denom = torch.where(norm > limit, limit / norm, torch.ones_like(norm))
    return vec * denom


# ---- internal coordinates (agdiff_tpu/ops/geometry.py:76-128; off the
# diffusion path)

def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def get_angle(pos, angle_index):
    """Angles at center atoms: angle_index (3, A) rows (n1, ctr, n2) into
    pos (N, 3); (A, 1) radians."""
    n1, ctr, n2 = angle_index
    v1 = pos[n1] - pos[ctr]
    v2 = pos[n2] - pos[ctr]
    inner = torch.sum(v1 * v2, dim=-1, keepdim=True)
    length = _norm(v1) * _norm(v2)
    return torch.arccos(torch.clamp(inner / torch.clamp(length, min=EPS),
                                    -1.0, 1.0))


def get_dihedral(pos, dihedral_index):
    """Dihedral angles: dihedral_index (4, A) rows (n1, ctr1, ctr2, n2);
    (A, 1) radians in [0, pi]."""
    n1, ctr1, ctr2, n2 = dihedral_index
    v_ctr = pos[ctr2] - pos[ctr1]
    nrm1 = torch.linalg.cross(v_ctr, pos[n1] - pos[ctr1])
    nrm2 = torch.linalg.cross(v_ctr, pos[n2] - pos[ctr2])
    inner = torch.sum(nrm1 * nrm2, dim=-1, keepdim=True)
    length = _norm(nrm1) * _norm(nrm2)
    return torch.arccos(torch.clamp(inner / torch.clamp(length, min=EPS),
                                    -1.0, 1.0))


def convert_cluster_score_d(cluster_score_d, cluster_pos, cluster_edge_mask,
                            cluster_edge_length, subgraph_index):
    """Cluster distance scores (B, K, K) -> per-node position scores
    (B, N, 3): eq_transform_dense at cluster level, each node taking its
    cluster's row through subgraph_index (B, N)."""
    score_pos = eq_transform_dense(cluster_score_d, cluster_pos,
                                   cluster_edge_mask, cluster_edge_length)
    index = subgraph_index.long()[..., None].expand(
        subgraph_index.shape + (score_pos.shape[-1],))
    return torch.gather(score_pos, -2, index)
