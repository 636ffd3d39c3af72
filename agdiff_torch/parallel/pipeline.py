"""Pipeline parallelism (GPipe schedule) over a 'pp' mesh axis (port of
agdiff_tpu/parallel/pipeline.py).

The JAX package writes the pipeline as one SPMD program, a shard_map
whose body scans over the schedule's ticks and rotates activations
between neighbouring stages with lax.ppermute. The port runs the same
program on each rank, eagerly: rank i holds stage i's parameters and, for
M microbatches over S stages, runs its stage every one of the M + S - 1
ticks. A tick outside the rank's window (t < i or t - i >= M) is masked:
the stage runs and its output is discarded, as JAX's `where` discards it.
Stage 0 takes microbatch t in, the last stage keeps microbatch t - i,
the outputs rotate one stage on (Mesh.ppermute_with_grad), and the
result is replicated by a masked sum over the axis.

The selections are torch.where, never a Python branch, so that every
rank's autograd graph holds every rotation: the backward's collectives
(each rotation's inverse) then run on every rank in the same order. The
result is differentiable in the stage parameters (each rank gets its
stage's gradient) and in the input (every rank gets the whole
gradient): backpropagating through it is pipeline-parallel training.

`schnet_pipeline` pipelines the SchNet interaction stack of a fast
forward (models/fast_forward.py): each block's distance weights, K3
(kernels/fused.py interaction_block_aggregate) and the node tail. K3 has
no backward, in this package as in JAX's (agdiff_tpu/ops/pallas/fused.py
has no custom_vjp), so a stage asked for a gradient runs K3's plain
version, as JAX's use_pallas=False does.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from agdiff_torch.kernels.fused import (
    interaction_block_aggregate,
    interaction_block_aggregate_plain,
)
from agdiff_torch.models.fast_forward import (
    node_input,
    schnet_block,
    stacked_distance_weights,
)
from agdiff_torch.parallel.mesh import Mesh, make_mesh


def make_pp_mesh(num_devices: int, axis_name: str = "pp") -> Mesh:
    """A 1-D pipeline mesh over the world: stage i on rank i
    (pipeline.py:47-56)."""
    return make_mesh(num_devices, axis_name)


def stack_stage_params(per_stage_params):
    """S structurally identical per-stage pytrees stacked along a new
    leading stage axis (pipeline.py:59-63)."""
    return pytree.tree_map(lambda *leaves: torch.stack(leaves),
                           per_stage_params[0], *per_stage_params[1:])


def stage_slice(stage_params, s: int):
    """Stage s's parameters of stacked ones: copies (a gradient still
    reaches the stack), each in storage of its own, aligned as the
    kernels' weights must be."""
    return pytree.tree_map(lambda a: a[s].clone(), stage_params)


def _stage_of(stage_params, line: Mesh, axis: str):
    """This rank's stage of stacked parameters (leading axis S)."""
    lead = pytree.tree_leaves(stage_params)[0].shape[0]
    if lead != line.world_size:
        raise ValueError(f"stage_params leading axis {lead} != mesh "
                         f"'{axis}' size {line.world_size}")
    return stage_slice(stage_params, line.rank)


def _schedule(stage_fn: Callable, params, x, line: Mesh):
    """The GPipe schedule on this rank: params its stage's, x the
    replicated (M, ...) microbatches; returns the (M, ...) outputs,
    replicated."""
    S, i = line.world_size, line.rank
    leaves, spec = pytree.tree_flatten(x)
    M = leaves[0].shape[0]
    dev = leaves[0].device
    flag = lambda b: torch.tensor(bool(b), device=dev)  # noqa: E731
    xs = [line.replicate(a) for a in leaves]
    state = [torch.zeros_like(a[0]) for a in xs]
    buf = [[torch.zeros_like(a[0]) for _ in range(M)] for a in xs]
    ring = [(j, (j + 1) % S) for j in range(S)]
    for t in range(M + S - 1):
        tc = min(max(t, 0), M - 1)
        state_in = [torch.where(flag(i == 0), a[tc], s)
                    for a, s in zip(xs, state)]
        active = flag(t >= i and t - i < M)
        out = pytree.tree_leaves(stage_fn(
            params, pytree.tree_unflatten(state_in, spec)))
        out = [torch.where(active, o, s) for o, s in zip(out, state_in)]
        m = min(max(t - i, 0), M - 1)
        take = flag(i == S - 1 and t >= i and t - i < M)
        for b, o in zip(buf, out):
            b[m] = torch.where(take, o, b[m])
        state = [line.ppermute_with_grad(o, ring) for o in out]
    last = flag(i == S - 1)
    result = [line.sum_replicated(torch.where(
        last, torch.stack(b), torch.zeros((), dtype=b[0].dtype, device=dev)))
        for b in buf]
    return pytree.tree_unflatten(result, spec)


def pipeline_apply(stage_fn: Callable, stage_params, x, *, mesh: Mesh,
                   axis: str = "pp"):
    """Run x's leading-axis microbatches through S pipeline stages
    (pipeline.py:66-128).

    stage_fn(params, xm) -> xm, shape- and dtype-preserving; xm a pytree
    (tuples, lists, dicts) of tensors. stage_params: a pytree with leading
    axis S = mesh.shape[axis]. x: a pytree of (M, ...) microbatches, the
    same on every rank (stage 0 takes them in). Returns the (M, ...)
    output pytree on every rank."""
    line = mesh.axis(axis)
    return _schedule(stage_fn, _stage_of(stage_params, line, axis), x, line)


def jit_pipeline(stage_fn: Callable, mesh: Mesh, axis: str = "pp"):
    """(run, place) (pipeline.py:131-141): place(stacked) is this rank's
    stage parameters, run(placed, x) the pipeline on them."""
    line = mesh.axis(axis)

    def place(stage_params):
        return _stage_of(stage_params, line, axis)

    def run(placed, x):
        return _schedule(stage_fn, placed, x, line)

    return run, place


def schnet_stage(forward) -> Callable:
    """The stage body over `forward`'s SchNet blocks: stage_fn(blocks,
    (h, e, el, env)) -> (h', e, el, env) for one microbatch, h (b, N, F)
    f32, e (b, N, N, C) at the forward's compute dtype, el (b, N, N, 1)
    and env (b, N, N) f32. Each block: its two distance-weight planes as
    PallasForward builds them, K3 (its plain version on the CPU, or when
    a gradient is asked for), the node tail."""

    def stage_fn(blocks, payload):
        h, e, el, env = payload
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in pytree.tree_leaves((blocks, payload)))
        aggregate = (interaction_block_aggregate_plain if grad
                     else interaction_block_aggregate)
        b, n = env.shape[:2]
        we = stacked_distance_weights(
            blocks, el.reshape(b, n * n, 1), env.reshape(b, n * n),
            forward.sigmoid).reshape(-1, b, n, n)
        for k, blk in enumerate(blocks):
            c1, c2 = blk["convs"]
            a1, a2 = aggregate(e, we[2 * k], we[2 * k + 1],
                               node_input(c1, h), node_input(c2, h), c1, c2)
            h = schnet_block(blk, h, a1, a2, forward.softplus,
                             forward.sigmoid)
        return (h, e, el, env)

    return stage_fn


def schnet_pipeline(forward, mesh: Mesh, axis: str = "pp"):
    """Pipeline the SchNet interaction stack of a fast forward
    (models/fast_forward.py; `forward.blocks`) over the mesh's `axis`
    (pipeline.py:144-177). Stages are contiguous groups of blocks
    (len(blocks) must divide into mesh.shape[axis]). Returns (run,
    stacked): run(stacked, payload) -> h, payload = (h, e, el, env)
    stacked on a leading microbatch axis; the edge context rides through
    the pipeline with the activations."""
    blocks = forward.blocks
    S = mesh.shape[axis]
    if len(blocks) % S:
        raise ValueError(f"{len(blocks)} blocks not divisible into {S} "
                         f"stages")
    per = len(blocks) // S
    stacked = stack_stage_params(
        [tuple(blocks[i * per:(i + 1) * per]) for i in range(S)])
    stage_fn = schnet_stage(forward)

    def run(stage_params, payload):
        return pipeline_apply(stage_fn, stage_params, payload, mesh=mesh,
                              axis=axis)[0]

    return run, stacked
