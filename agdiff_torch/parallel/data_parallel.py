"""Data-parallel train step, distill step and sampler over a group (port
of agdiff_tpu/parallel/data_parallel.py).

The JAX package jits the single-device step with the batch's graph axis
sharded over the mesh and parameters replicated; XLA's SPMD partitioner
then computes the same function as the single-device step over the
global batch. Here each rank runs the step on its shard of the graph
axis (`shard_graph_batch`) and the few quantities that span the global
batch cross the ranks explicitly (train/train_step.py, models/loss.py,
nn/common.py::synced_batch_stats, ops/masked.py):

  * the timesteps and the noise are drawn at the global batch's shape
    from the same generator on every rank and sliced;
  * train-mode BatchNorm takes its statistics over every real node of
    the global batch, with their gradient across the ranks;
  * the loss divides the rank's masked sums by the global real-node
    count, and the logged loss is the sum over the ranks;
  * the gradients are summed over the ranks in one flat all-reduce (not
    averaged as DistributedDataParallel does: DDP's mean of per-rank
    means differs from the global mean whenever the ranks hold different
    numbers of real nodes), so the clip, the non-finite skip, the two
    Adams and the EMA take the same decisions on every rank.

Sampling needs no collective but the gather of the samples: every graph
is its own (sampling/langevin.py Sampler with a group).

A group is a 1-D mesh (the world) or the multi-slice ('dcn', 'dp') mesh
of make_mesh(n, dcn_slices=k) (agdiff_tpu/parallel/data_parallel.py:19):
the graph axis is sharded over both axes in rank order, and the gradient
sum runs within each slice, then across the slices
(Mesh.sum_gradients).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from agdiff_torch.config import Config
from agdiff_torch.data.graph_batch import GraphBatch
from agdiff_torch.parallel.mesh import Mesh
from agdiff_torch.sampling.langevin import (
    SamplerConfig,
    build_fast_sampler,
    build_sampler,
)
from agdiff_torch.train.distill import DistillStep
from agdiff_torch.train.train_step import TrainStep


def shard_graph_batch(batch: GraphBatch, group: Mesh) -> GraphBatch:
    """This rank's rows of a (host) batch's graph axis, on its device;
    raises when the axis does not split evenly over the ranks
    (agdiff_tpu/parallel/data_parallel.py:31-37)."""
    return group.shard(batch)


def make_parallel_train_step(config: Config, group: Mesh) -> TrainStep:
    """The train step over the group: (state, shard[, t, noise]) ->
    StepMetrics of the global batch, with `t` and `noise` the global
    batch's when injected (:40-54)."""
    return TrainStep(config, group.device, group)


def make_parallel_chunked_train_step(config: Config, chunk: int,
                                     group: Mesh):
    """K = chunk data-parallel steps over a group of same-bucket shards
    (:81-101; the port's step_chunk is a loader group run step by step):
    (state, shards[, ts, noises]) -> the last step's metrics."""
    step = make_parallel_train_step(config, group)

    def chunked(state, shards: List[GraphBatch], ts=None, noises=None):
        if len(shards) != chunk:
            raise ValueError(f"{len(shards)} shards for a chunk of {chunk}")
        for i, shard in enumerate(shards):
            metrics = step(state, shard, None if ts is None else ts[i],
                           None if noises is None else noises[i])
        return metrics

    return chunked


def make_parallel_distill_step(config: Config, sampler_config: SamplerConfig,
                               n_student: int, group: Mesh,
                               weighting: str = "trunc-snr") -> DistillStep:
    """The distill step over the group (:57-78): (state, teacher, shard[,
    k, noise]) -> DistillMetrics of the global batch."""
    return DistillStep(config, sampler_config, n_student, group.device,
                       weighting, group)


def make_parallel_sampler(model, diffusion, sampler_config: SamplerConfig,
                          group: Mesh, forward_fn=None,
                          pair_capacity: Optional[int] = None,
                          graph: bool = True):
    """The sampler over the group (:114-143): run(global batch, pos_init,
    generator=None, noise=None) -> every rank's samples. forward_fn, a
    folded forward, replaces the dense module."""
    if forward_fn is None:
        return build_sampler(model, diffusion, sampler_config, graph=graph,
                             group=group)
    return build_fast_sampler(forward_fn, diffusion, sampler_config,
                              pair_capacity=pair_capacity, graph=graph,
                              group=group)


@torch.no_grad()
def check_replicas(module: torch.nn.Module, group: Mesh) -> None:
    """Raise on every rank unless every rank's parameters and buffers
    equal rank 0's, bit for bit (DDP's start-up check)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in
                      list(module.parameters()) + list(module.buffers())])
    ref = group.broadcast(flat.clone())
    differs = torch.tensor([0.0 if torch.equal(flat, ref) else 1.0],
                           device=flat.device)
    if float(group.all_reduce(differs)):
        raise RuntimeError("the ranks' parameters differ from rank 0's")
