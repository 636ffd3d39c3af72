"""Masked reductions and BatchNorm statistics for padded batches (port of
agdiff_tpu/ops/masked.py:18-46).

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
