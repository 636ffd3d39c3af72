"""Sharded-parameter training layouts: FSDP and tensor parallelism over a
2-D mesh (port of agdiff_tpu/parallel/sharded.py).

The JAX package writes both as GSPMD sharding annotations and lets XLA
insert every collective. Here each rank holds its slice of every sharded
leaf and the collectives are written out (parallel/mesh.py), so that the
step computes what the single-device step computes over the global batch:

  * The layout is JAX's. `spec_for_array` shards a leaf of at least
    `min_size` elements on its largest axis that the model axis divides,
    the last one on a tie, and replicates the rest. A spec is a tuple in
    JAX's axis order, taken on the JAX leaf's shape: a flax kernel is
    (in, out) where the port's Linear weight is (out, in)
    (models/weights.py), so a square kernel shards the port's dim 0. Both
    Adams' moments and the EMA shadow take their parameter's spec.
  * `shard_train_state` cuts the port's TrainState in place: the module's
    sharded parameters and buffers become this rank's slices, and so do
    their moments and shadows (train/optimizer.py `TwoAdams.use_shards`).
  * mode 'fsdp': the batch's graph axis is sharded over every mesh axis.
    At use, the sharded parameters are all-gathered (one flat
    gradient-carrying all-gather, whose backward reduce-scatters each
    gradient to its shard), the sharded buffers likewise without a
    gradient. The shard gradients are then summed over the other axis,
    the whole ones over every rank: the step is over the global batch, a
    sum, not DDP's average. BatchNorm takes the statistics of every rank.
  * mode 'tp': the batch is sharded over the non-'tp' axis and replicated
    over 'tp'. A Linear whose weight is sharded on its output features
    computes its slice of them and all-gathers it (column-parallel); one
    sharded on its input features multiplies its slice of the input and
    all-reduces the partial product (row-parallel) (nn/common.py
    `tensor_parallel`). Any other sharded leaf (an embedding) is gathered
    at use. Every 'tp' rank computes the same loss; the collectives'
    backwards count a whole leaf's gradient once, and the gradients are
    summed over the data axis. BatchNorm takes the statistics of the data
    axis.
  * The clip's global norm and the finite check span the model axis; Adam
    runs on each slice.
  * mode 'sp' (spatial, node-axis sharding, for protein-scale N whose
    (B, N, N, C) pair tensors outgrow one card): the state stays whole
    on every rank; the batch's graph axis is sharded over the non-'sp'
    axes and its node axis over 'sp', so that each rank holds a row
    block of every pair tensor (graph_batch_node_sharding). The forward
    runs under a node layout (parallel/mesh.py NodeLayout): the j side of
    every pair op all-gathers a small (B, N, F) node tensor, the
    equivariant transform's transposed terms reduce-scatter a (B, N, 3)
    column partial, BatchNorm and the loss's count span every rank, and
    the gradients are summed over every rank (train/train_step.py).
    Under packed_pairs each rank holds its owned pairs of the triangle
    (ops/pairs.py owned_pairs), P / sp of them: the j-side messages and
    the mirrored planes reach their rows through one (B, N, F)
    reduce-scatter a message layer and a plane.

The reference has no analog of any of this (SURVEY.md section 2.5).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from agdiff_torch.config import Config
from agdiff_torch.data.graph_batch import GraphBatch
from agdiff_torch.models.weights import flax_leaf, load_jax_variables
from agdiff_torch.nn.common import Linear, tensor_parallel
from agdiff_torch.parallel.mesh import Mesh, make_hybrid_mesh  # noqa: F401
from agdiff_torch.train.train_step import TrainState, TrainStep

#: tensors smaller than this many elements stay replicated (biases, BN
#: vectors, scalars), as in the JAX package
MIN_SHARD_SIZE = 1024

MODES = ("fsdp", "tp", "sp")


def spec_for_array(x, n_shard: int, axis_name: str,
                   min_size: int = MIN_SHARD_SIZE) -> tuple:
    """The spec of one tensor (or shape): () to replicate it, else a
    tuple naming `axis_name` on its largest axis divisible by n_shard,
    the last such on a tie (agdiff_tpu/parallel/sharded.py:75-89)."""
    shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
    if not shape or math.prod(shape) < min_size:
        return ()
    best = None
    for i, d in enumerate(shape):
        if d > 1 and d % n_shard == 0:
            if best is None or d >= shape[best]:
                best = i
    if best is None:
        return ()
    return tuple(axis_name if i == best else None for i in range(len(shape)))


def leaf_shape(module: nn.Module, name: str, t: torch.Tensor) -> tuple:
    """The shape of the JAX leaf of a parameter or buffer of the port: a
    Linear weight (out, in) is the flax kernel (in, out)."""
    _, path = flax_leaf(module, name)
    shape = tuple(t.shape)
    return shape[::-1] if path[-1] == "kernel" else shape


def torch_dim(module: nn.Module, name: str, spec: tuple) -> Optional[int]:
    """The dim of the port's tensor that a JAX-order spec shards (None:
    replicated)."""
    axes = [i for i, a in enumerate(spec) if a is not None]
    if not axes:
        return None
    _, path = flax_leaf(module, name)
    return len(spec) - 1 - axes[0] if path[-1] == "kernel" else axes[0]


def _named(module: nn.Module):
    return list(module.named_parameters()) + list(module.named_buffers())


def state_specs(state: TrainState, mesh: Mesh, axis: str,
                min_size: int = MIN_SHARD_SIZE) -> Dict[str, tuple]:
    """{parameter or buffer name: spec} of a TrainState over the mesh's
    `axis` (agdiff_tpu/parallel/sharded.py:92-101); each parameter's Adam
    moments and EMA shadow take its spec. A sharded state gives the specs
    it was cut by."""
    if state.layout is not None:
        return dict(state.layout.specs)
    n = mesh.shape[axis]
    return {name: spec_for_array(leaf_shape(state.module, name, t), n, axis,
                                 min_size)
            for name, t in _named(state.module)}


def state_shardings(state: TrainState, mesh: Mesh, axis: str,
                    min_size: int = MIN_SHARD_SIZE) -> Dict[str, int]:
    """{name: the dim of the port's tensor that is cut} for the leaves
    the specs shard (the others are whole on every rank)."""
    specs = state_specs(state, mesh, axis, min_size)
    dims = {n: torch_dim(state.module, n, s) for n, s in specs.items()}
    return {n: d for n, d in dims.items() if d is not None}


def _owner(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    scope, _, leaf = name.rpartition(".")
    return (module.get_submodule(scope) if scope else module), leaf


@dataclass
class ShardLayout:
    """How a sharded TrainState is cut: the mesh, the model axis, every
    leaf's spec, the dim each sharded leaf is cut on and its whole
    shape."""

    mesh: Mesh
    axis: str
    specs: Dict[str, tuple]
    dims: Dict[str, int]
    shapes: Dict[str, tuple]

    @property
    def line(self) -> Mesh:
        """This rank's line along the model axis."""
        return self.mesh.axis(self.axis)

    def cut(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole tensor of leaf `name`."""
        d, line = self.dims[name], self.line
        k = t.shape[d] // line.world_size
        return t.narrow(d, line.rank * k, k)

    def whole(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's shard (no gradient)."""
        return self.line.concat(shard.detach().contiguous(), self.dims[name])

    def rank_bytes(self, state: TrainState) -> Tuple[int, int]:
        """(bytes this rank holds, bytes of the whole state) over the
        parameters, both Adams' moments, the EMA shadow and the
        buffers."""
        held = whole = 0
        params = dict(state.module.named_parameters())
        for name, t in _named(state.module):
            copies = 3 + (state.ema is not None) if name in params else 1
            size = math.prod(self.shapes.get(name, tuple(t.shape)))
            held += t.numel() * t.element_size() * copies
            whole += size * t.element_size() * copies
        return held, whole

    def _gathered(self, named, grad: bool) -> Dict[str, torch.Tensor]:
        """The whole tensors of the sharded `named` (name, shard) pairs,
        through one flat all-gather over the model axis."""
        if not named:
            return {}
        line = self.line
        flat = torch.cat([t.reshape(-1) for _, t in named])
        rows = (line.all_gather_with_grad(flat) if grad
                else line.all_gather(flat.detach()))
        out, at = {}, 0
        for name, t in named:
            pieces = rows[:, at:at + t.numel()].reshape(
                (line.world_size,) + tuple(t.shape))
            out[name] = torch.cat(list(pieces.unbind(0)), self.dims[name])
            at += t.numel()
        return out

    @contextlib.contextmanager
    def materialized(self, module: nn.Module, mode: str):
        """The module whole inside this context (parallel/sharded.py
        docstring; forward and backward both run inside it, a remat
        recomputation too). 'fsdp': every sharded leaf gathered. 'tp':
        every sharded Linear weight stays a shard under nn.common's
        tensor_parallel, every other sharded parameter gathered at use
        (its backward keeps this rank's slice). Sharded buffers (the
        running statistics) are gathered and their moved values cut back
        on leaving."""
        if mode not in ("fsdp", "tp"):
            raise ValueError(f"unknown mode {mode!r}")
        line = self.line
        params = [(n, p) for n, p in module.named_parameters()
                  if n in self.dims]
        buffers = [(n, b) for n, b in module.named_buffers()
                   if n in self.dims]
        plan = {}
        if mode == "fsdp":
            swap = self._gathered(params, grad=True)
        else:
            swap = {}
            for name, p in params:
                owner, leaf = _owner(module, name)
                if isinstance(owner, Linear) and leaf == "weight":
                    plan[owner] = (self.dims[name], line)
                else:
                    swap[name] = line.gather_replicated(p, self.dims[name])
        whole_buffers = self._gathered(buffers, grad=False)
        swap.update(whole_buffers)
        saved = []
        for name, t in swap.items():
            owner, leaf = _owner(module, name)
            table = (owner._parameters if leaf in owner._parameters
                     else owner._buffers)
            saved.append((table, leaf, table[leaf]))
            table[leaf] = t
        try:
            with tensor_parallel(plan or None):
                yield
        finally:
            for table, leaf, t in reversed(saved):
                table[leaf] = t
            with torch.no_grad():
                for name, b in buffers:
                    b.copy_(self.cut(name, whole_buffers[name]))

    @torch.no_grad()
    def sum_gradients(self, optimizer, mode: str) -> None:
        """Each shard's and whole parameter's .grad summed over the ranks
        that hold a share of it: 'fsdp' the shards' over the data axis
        (the model axis summed them in the gather's backward), the whole
        ones' over every rank; 'tp' both over the data axis."""
        rest = self.mesh.others(self.axis)
        everyone = rest if mode == "tp" else self.mesh
        for group, keep in ((rest, True), (everyone, False)):
            params = [p for p, s in zip(optimizer.params, optimizer.sharded)
                      if s == keep]
            if group is not None and params:
                group.sum_gradients(params)


def shard_train_state(state: TrainState, mesh: Mesh, axis: str,
                      min_size: int = MIN_SHARD_SIZE,
                      variables=None) -> TrainState:
    """Cut a whole TrainState in place to this rank's slices over the
    mesh's `axis` (agdiff_tpu/parallel/sharded.py:111): the module's
    sharded parameters and buffers, both Adams' moments, the EMA shadow.
    `variables`, a JAX variables tree of numpy leaves, is loaded into the
    module first (models/weights.py load_jax_variables), so that both
    packages step from the same weights. Returns the state, its `layout`
    set."""
    if state.layout is not None:
        raise ValueError("the state is sharded already")
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no '{axis}' axis")
    module = state.module
    if variables is not None:
        load_jax_variables(module, variables)
    specs = state_specs(state, mesh, axis, min_size)
    dims = {n: d for n, d in ((n, torch_dim(module, n, s))
                              for n, s in specs.items()) if d is not None}
    layout = ShardLayout(mesh, axis, specs, dims, {
        n: tuple(t.shape) for n, t in _named(module) if n in dims})
    shards = {}
    for name, t in _named(module):
        if name not in dims:
            continue
        owner, leaf = _owner(module, name)
        piece = layout.cut(name, t.detach()).clone()
        if leaf in owner._parameters:
            shard = nn.Parameter(piece)
            shards[id(t)] = (shard, lambda x, n=name: layout.cut(n, x))
            owner._parameters[leaf] = shard
        else:
            owner._buffers[leaf] = piece
    state.optimizer.use_shards(shards, layout.line)
    if state.ema is not None:
        state.ema = {n: layout.cut(n, v).clone() if n in dims else v
                     for n, v in state.ema.items()}
    state.layout = layout
    return state


def gather_state(state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    """The whole tensors of a sharded state by name (no gradient):
    'params', 'buffers', 'grads' (zeros where a parameter has none),
    'mu' and 'nu' (each Adam's, by parameter name) and 'ema' (when the
    state has one). Collective over the model axis; a whole state (mode
    'sp') gives copies."""
    layout, module = state.layout, state.module

    def whole(name, t):
        if layout is not None and name in layout.dims:
            return layout.whole(name, t)
        return t.detach().clone()

    named = list(module.named_parameters())
    opt = state.optimizer
    moments = {}
    for adam in opt.adams.values():
        for p, mu, nu in zip(adam.params, adam.mu, adam.nu):
            moments[id(p)] = (mu, nu)
    out = {
        "params": {n: whole(n, p) for n, p in named},
        "buffers": {n: whole(n, b) for n, b in module.named_buffers()},
        "grads": {n: whole(n, torch.zeros_like(p) if p.grad is None
                           else p.grad) for n, p in named},
        "mu": {n: whole(n, moments[id(p)][0]) for n, p in named},
        "nu": {n: whole(n, moments[id(p)][1]) for n, p in named},
    }
    if state.ema is not None:
        out["ema"] = {n: whole(n, v) for n, v in state.ema.items()}
    return out


def _graph_batch_sharding(mesh: Mesh, axes) -> Mesh:
    """The mesh a batch's graph axis is sharded over: `axes` of `mesh`
    (agdiff_tpu/parallel/sharded.py:114-119)."""
    return mesh.axis(*axes)


@dataclass(frozen=True)
class NodeSharding:
    """Spatial (node-axis) sharding of a GraphBatch: the graph axis over
    `graphs` (None: whole on every rank), the node axis over `nodes`, the
    'sp' line. A rank's shard: atom_type and node_mask (b, N/sp), pos
    (b, N/sp, 3), bond_adj (b, N/sp, N) (its node rows, every column),
    graph_mask (b,)."""

    graphs: Optional[Mesh]
    nodes: Mesh

    def _slices(self, batch: GraphBatch):
        b, n = batch.atom_type.shape
        sp = self.nodes.world_size
        if n % sp:
            raise ValueError(f"a node axis of {n} does not split over "
                             f"{sp} 'sp' ranks")
        rows = slice(None) if self.graphs is None else self.graphs.rows(b)
        k = n // sp
        return rows, slice(self.nodes.rank * k, (self.nodes.rank + 1) * k)

    def shard(self, batch: GraphBatch) -> GraphBatch:
        """This rank's (graph rows, node rows) of a host batch, on its
        device."""
        rows, nodes = self._slices(batch)

        def cut(x, node_axis=True):
            x = x[rows]
            return (x[:, nodes] if node_axis else x).to(self.nodes.device)
        return GraphBatch(
            atom_type=cut(batch.atom_type), pos=cut(batch.pos),
            node_mask=cut(batch.node_mask), bond_adj=cut(batch.bond_adj),
            graph_mask=cut(batch.graph_mask, node_axis=False))


def graph_batch_node_sharding(mesh: Mesh, node_axis: str = "sp",
                              data_axes=("dp",)) -> NodeSharding:
    """The spatial sharding of a batch (agdiff_tpu/parallel/sharded.py:
    127-143): the graph axis over `data_axes` of the mesh, the node axis
    over `node_axis`; every (B, N, N, ...) pair tensor the forward builds
    is then this rank's row block."""
    data_axes = tuple(a for a in data_axes if a != node_axis)
    return NodeSharding(mesh.axis(*data_axes) if data_axes else None,
                        mesh.axis(node_axis))


def make_sharded_train_step(config: Config, mesh: Mesh,
                            state: Optional[TrainState] = None,
                            mode: str = "fsdp") -> TrainStep:
    """The train step over a sharded state (sharded.py:146-188):
    (state, shard[, t, noise]) -> StepMetrics of the global batch, with
    `shard` this rank's rows of the batch sharded over every mesh axis
    ('fsdp') or over the non-'tp' axes ('tp'; shard_graph_batch_over),
    or, for 'sp', its graph rows over the non-'sp' axes and its node rows
    over 'sp' (shard_graph_batch_nodes), and `t` and `noise` the global
    batch's when injected. `state`, when given and cut, must be cut over
    this mesh's axis of the mode (shard_train_state); 'sp' takes a whole
    state, the same on every rank."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no '{mode}' axis")
    if mode == "sp":
        if state is not None and state.layout is not None:
            raise ValueError("mode 'sp' keeps the state whole: pass it "
                             "uncut")
        return TrainStep(config, mesh.device, mesh, mode)
    if state is not None and state.layout is not None and (
            state.layout.axis != mode or state.layout.mesh != mesh):
        raise ValueError(f"the state is cut over {state.layout.axis!r}, "
                         f"the step's mode is {mode!r}")
    axes = (mesh.axis_names if mode == "fsdp"
            else tuple(a for a in mesh.axis_names if a != "tp"))
    group = _graph_batch_sharding(mesh, axes) if axes else None
    return TrainStep(config, mesh.device, group, mode)


def shard_graph_batch_over(batch: GraphBatch, mesh: Mesh,
                           axes) -> GraphBatch:
    """This rank's rows of a (host) batch with the graph axis sharded over
    `axes` of the mesh, on its device (sharded.py:191-194)."""
    return _graph_batch_sharding(mesh, tuple(axes)).shard(batch)


def shard_graph_batch_nodes(batch: GraphBatch, mesh: Mesh,
                            node_axis: str = "sp",
                            data_axes=("dp",)) -> GraphBatch:
    """This rank's shard of a (host) batch with the node axis sharded over
    `node_axis` and the graph axis over `data_axes`, on its device
    (sharded.py:197-203); a node axis that does not split evenly raises
    ValueError."""
    return graph_batch_node_sharding(mesh, node_axis,
                                     tuple(data_axes)).shard(batch)
