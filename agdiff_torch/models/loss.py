"""Denoising-diffusion training loss (port of agdiff_tpu/models/loss.py:
38-107; reference: dualenc.py:284-395).

  * antithetic timesteps: t ~ U[0, T) for half the graphs, T - 1 - t for
    the mirror half;
  * perturbation pos~ = pos + eps * sqrt(1 - a) / sqrt(a), a = alpha_bar[t]
    per graph, the noise zero on padded nodes;
  * target d = (d_gt - d~) * sqrt(a) / sqrt(1 - a) on every edge;
  * global mask ((d~ <= cutoff) | local) & ~local & edge_mask;
  * loss = mean over real nodes of 2 |eq(global) - eq(target)|^2 + 5
    |eq(local) - eq(target)|^2.

The samplers take an explicit torch.Generator; `jax.random` and torch
streams differ, so the parity tests inject t and the noise.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from agdiff_torch.data.graph_batch import GraphBatch
from agdiff_torch.ops.geometry import eq_transform_dense, pairwise_distance

GLOBAL_WEIGHT = 2.0
LOCAL_WEIGHT = 5.0


class LossOutput(NamedTuple):
    loss: torch.Tensor         # scalar: masked mean over real nodes
    loss_global: torch.Tensor  # scalar
    loss_local: torch.Tensor   # scalar
    per_node: torch.Tensor     # (B, N) unreduced


def sample_timesteps(generator: torch.Generator, num_graphs: int,
                     num_timesteps: int, device=None) -> torch.Tensor:
    """(num_graphs,) int64: num_graphs // 2 + 1 draws, then their mirrors
    T - 1 - t, cut to num_graphs (dualenc.py:304-309)."""
    half = torch.randint(0, num_timesteps, (num_graphs // 2 + 1,),
                         generator=generator, device=device)
    return torch.cat([half, num_timesteps - half - 1])[:num_graphs]


def perturb_positions(batch: GraphBatch, alphas: torch.Tensor,
                      t: torch.Tensor, noise: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_perturbed, a): standard normal `noise` (B, N, 3), masked to
    real nodes and scaled by sqrt(1 - a) / sqrt(a)."""
    a = alphas[t]
    noise = noise * batch.node_mask[..., None]
    scale = torch.sqrt(1.0 - a) / torch.sqrt(a)
    return batch.pos + noise * scale[:, None, None], a


def global_edge_mask(d_perturbed, local, edge_mask, cutoff: float):
    """The global branch's edges: within the cutoff or local, minus the
    local ones, on the working graph (dualenc.py:352-357)."""
    return ((d_perturbed <= cutoff) | local) & ~local & edge_mask


def diffusion_loss(output, batch: GraphBatch, pos_perturbed: torch.Tensor,
                   a: torch.Tensor, cutoff: float, group=None,
                   nodes=None) -> LossOutput:
    """The dual global/local position-score loss of a model output taken
    at pos_perturbed. With a data-parallel `group` (parallel/mesh.py) the
    batch is this rank's shard and the sums are divided by the real-node
    count of every rank's shard together
    (agdiff_tpu/models/loss.py:98-105 over the global batch): the ranks'
    losses sum to the global one, and so do their gradients. Under a node
    layout `nodes` (spatial sharding; `group` then spans every rank of the
    mesh) the shard is this rank's node rows, the output's planes their
    row blocks: the equivariant transforms add the transposed terms from
    the other ranks (ops/geometry.py eq_transform_dense), and per_node
    and the sums are the rows'."""
    d_gt = pairwise_distance(
        batch.pos, None if nodes is None else nodes.gather(batch.pos))
    d_perturbed = output.edge_length
    a_edge = a[:, None, None]
    d_target = (d_gt - d_perturbed) / torch.sqrt(1.0 - a_edge) \
        * torch.sqrt(a_edge)
    local = output.local_mask
    gmask = global_edge_mask(d_perturbed, local, output.edge_mask, cutoff)

    target_global = eq_transform_dense(d_target, pos_perturbed, gmask,
                                       d_perturbed, nodes)
    eq_global = eq_transform_dense(output.edge_inv_global, pos_perturbed,
                                   gmask, d_perturbed, nodes)
    loss_global = GLOBAL_WEIGHT * torch.sum(
        (eq_global - target_global) ** 2, dim=-1)
    target_local = eq_transform_dense(d_target, pos_perturbed, local,
                                      d_perturbed, nodes)
    eq_local = eq_transform_dense(output.edge_inv_local, pos_perturbed,
                                  local, d_perturbed, nodes)
    loss_local = LOCAL_WEIGHT * torch.sum((eq_local - target_local) ** 2,
                                          dim=-1)

    w = (batch.node_mask & batch.graph_mask[:, None]).float()
    count = torch.sum(w)
    if group is not None:
        count = group.all_reduce(count)
    count = torch.clamp(count, min=1.0)
    per_node = (loss_global + loss_local) * w
    return LossOutput(loss=torch.sum(per_node) / count,
                      loss_global=torch.sum(loss_global * w) / count,
                      loss_local=torch.sum(loss_local * w) / count,
                      per_node=per_node)
