"""Masked reductions, BatchNorm statistics, a masked softmax, readouts
and coarse graining for padded batches (port of agdiff_tpu/ops/masked.py).

The reference's BatchNorm1d layers normalise over the concatenated real
nodes of a variadic batch; over a padded (B, N) block the same statistics
are taken over the masked entries only, across the whole block.
"""

from __future__ import annotations

from typing import Tuple

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None,
                keepdim: bool = False) -> torch.Tensor:
    """Mean of x over the entries where mask is True."""
    m = mask.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    if dim is None:
        return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)
    total = torch.sum(x * m, dim=dim, keepdim=keepdim)
    count = torch.clamp(torch.sum(m, dim=dim, keepdim=keepdim), min=1.0)
    return total / count


def masked_batch_norm_stats(
        x: torch.Tensor, mask: torch.Tensor, group=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance over the real nodes of a
    (B, N, C) block with a (B, N) mask; returns (mean (C,), var (C,),
    count ()). The biased variance normalises; the caller makes the
    unbiased one for the running update.

    With a data-parallel `group` (parallel/mesh.py) the statistics are
    those of every rank's block together, as JAX's SPMD step takes them
    over the global batch, in two passes over the ranks: the masked sums
    and the count give the mean, then the masked squared deviations from
    it give the variance. Both sums cross the ranks through an all-reduce
    whose backward sums the gradients, so each rank's loss reaches every
    rank's nodes through the statistics."""
    m = mask[..., None].to(x.dtype)
    total = (lambda t: t) if group is None else group.sum_with_grad
    sums = total(torch.cat([torch.sum(x * m, dim=(0, 1)),
                            torch.sum(m)[None]]))
    count = torch.clamp(sums[-1], min=1.0)
    mean = sums[:-1] / count
    var = total(torch.sum(((x - mean) ** 2) * m, dim=(0, 1))) / count
    return mean, var, count


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over the masked entries, 0 where mask is False
    (agdiff_tpu/ops/masked.py:48-56)."""
    neg = torch.finfo(logits.dtype).min
    z = torch.where(mask, logits, torch.full_like(logits, neg))
    z = z - torch.amax(z, dim=dim, keepdim=True).detach()
    e = torch.exp(z) * mask.to(logits.dtype)
    return e / torch.clamp(torch.sum(e, dim=dim, keepdim=True), min=1e-20)


# ---- graph readouts and coarse graining (agdiff_tpu/ops/masked.py:59-97;
# off the diffusion path)

def mean_readout(node_attr: torch.Tensor,
                 node_mask: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, C): the mean over the real nodes."""
    return masked_mean(node_attr, node_mask, dim=1)


def sum_readout(node_attr: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, C): the sum over the real nodes."""
    return torch.sum(node_attr * node_mask[..., None].to(node_attr.dtype),
                     dim=1)


def coarse_grain(pos: torch.Tensor, node_attr: torch.Tensor,
                 subgraph_onehot: torch.Tensor, node_mask: torch.Tensor):
    """Cluster pooling over a (B, N, K) one-hot assignment: (cluster
    positions (B, K, 3), the means of their real nodes; cluster features
    (B, K, C), the sums; cluster mask (B, K))."""
    w = subgraph_onehot * node_mask[..., None].to(subgraph_onehot.dtype)
    total = torch.sum(w, dim=1)
    counts = torch.clamp(total, min=1.0)
    cluster_pos = torch.einsum("bnk,bnc->bkc", w, pos) / counts[..., None]
    cluster_attr = torch.einsum("bnk,bnc->bkc", w, node_attr)
    return cluster_pos, cluster_attr, total > 0


def complete_graph_mask(node_mask: torch.Tensor) -> torch.Tensor:
    """(B, N) -> (B, N, N): every off-diagonal pair of real nodes."""
    n = node_mask.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=node_mask.device)
    return node_mask[:, :, None] & node_mask[:, None, :] & ~eye[None]
