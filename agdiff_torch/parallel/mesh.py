"""Device meshes over torch.distributed (port of agdiff_tpu/parallel/
mesh.py:26-58 and of make_hybrid_mesh, agdiff_tpu/parallel/sharded.py:
52-72).

The JAX package builds a device mesh inside one process and lets XLA's
SPMD partitioner insert the collectives. Here a mesh is one process a
device: `launch` spawns N ranks (torch.multiprocessing, spawn context),
each joins one process group (NCCL on the cards, gloo on the CPU) and runs
the caller's function with its `Mesh`: world size, rank, device, backend
and named axes. The world is the 1-D ('dp',) mesh. An N-D mesh
(`make_mesh(..., dcn_slices=)`, `make_hybrid_mesh`) lays the ranks out
row-major over its axes, as np.reshape lays out JAX's devices, and holds
the process group of this rank's line along each axis: `mesh.axis(name)`
is a Mesh over that line, the ranks that differ only in that axis.

The arithmetic that crosses ranks uses three collectives only,
`all_reduce`, `broadcast` and `barrier`: gloo supports no others on CUDA
tensors, and NCCL takes no CPU tensors. Built on them:

  * `all_gather`: every rank's tensor stacked, one broadcast of its bytes
    from each rank (exact, any dtype);
  * `reduce_scatter`: this rank's row of the sum of stacked tensors (an
    all-reduce, then the row);
  * `ppermute`: a tensor moved along a fixed permutation of the ranks, one
    broadcast of its bytes from each source (lax.ppermute);
  * `gather_rows`: every rank's rows concatenated, by an all-reduce of a
    zero-filled global buffer into which each rank wrote its own.

Each has a gradient-carrying form (`*_with_grad`) whose backward is the
adjoint: the sum's is the sum, all-gather's a reduce-scatter and the
other way round, ppermute's the inverse permutation. Two more pairs serve
a value that every rank then uses alike (tensor parallelism, the
pipeline's result): `replicate` (identity, its backward the sum) and
`sum_replicated` (the sum, its backward the identity).

Every collective of a world fails after INIT_TIMEOUT_S, so a hung world
fails; a message that may wait on a client (a server's next request)
goes through a control group (`Mesh.control`) that waits as long as a
server stays up.

`launch(..., device="cuda:0", backend="gloo")` puts every rank on one
card (NCCL refuses two ranks on one device): the cross-rank arithmetic
on a one-card machine. Asking for more cards than the machine has
raises, a failed initialisation raises, and a rank that dies fails the
whole run (the others are terminated): there is no fallback to fewer
devices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import math
import os
import pickle
import socket
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

INIT_TIMEOUT_S = 60.0   # rendezvous and every collective: a hung world fails
# a control group's collectives: a server's follower waits in one for the
# next client, however long that takes
IDLE_TIMEOUT_S = 365 * 86400.0


def _part(size: int, n: int) -> int:
    if size % n:
        raise ValueError(f"an axis of {size} does not split over {n} ranks")
    return size // n


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh of ranks: the default process group of
    its world, or `pg`, a group of the ranks `members` (global ranks in
    mesh order; empty: the world's 0 .. world_size - 1). `world_size` and
    `rank` are the mesh's own; `dims` the size of each of `axis_names`
    (empty: one axis of world_size); `lines` this rank's sub-meshes, by
    the axis names they span."""

    world_size: int
    rank: int
    device: torch.device
    backend: str
    pg: Any = None
    axis_names: Tuple[str, ...] = ("dp",)
    dims: Tuple[int, ...] = ()
    members: Tuple[int, ...] = ()
    lines: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as a JAX mesh's shape."""
        return dict(zip(self.axis_names, self.dims or (self.world_size,)))

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes files and logs."""
        return self.rank == 0

    def axis(self, *names: str) -> "Mesh":
        """The mesh over this rank's line along `names`: the ranks whose
        coordinates differ only on those axes."""
        for name in names:
            if name not in self.axis_names:
                raise ValueError(f"mesh {self.axis_names} has no {name!r} "
                                 f"axis")
        key = tuple(a for a in self.axis_names if a in names)
        if key == self.axis_names:
            return self
        return self.lines[key]

    def others(self, name: str) -> Optional["Mesh"]:
        """The mesh over every axis but `name` (None on a 1-D mesh)."""
        rest = tuple(a for a in self.axis_names if a != name)
        return self.axis(*rest) if rest else None

    def rows(self, batch_size: int) -> slice:
        """This rank's contiguous rows of a graph axis of `batch_size`;
        raises when the axis does not split evenly, as a JAX sharding
        does."""
        if batch_size % self.world_size:
            raise ValueError(
                f"batch of {batch_size} graphs does not split over "
                f"{self.world_size} devices")
        b = batch_size // self.world_size
        return slice(self.rank * b, (self.rank + 1) * b)

    def shard(self, batch):
        """This rank's rows of a GraphBatch's graph axis, on its device."""
        rows = self.rows(batch.num_graphs)
        return batch.replace(**{
            f.name: getattr(batch, f.name)[rows].to(self.device,
                                                    non_blocking=True)
            for f in dataclasses.fields(batch)})

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of `x`, in place (no gradient)."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.pg)
        return x

    def sum_with_grad(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of `x`, whose backward sums the ranks'
        gradients: each rank's loss reaches every rank's inputs."""
        return with_adjoint(x, lambda t: self.all_reduce(t.clone()),
                            lambda g: self.all_reduce(g.clone()))

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """`x`, the same on every rank, for each rank to use on its own
        share of the work: the backward sums the ranks' gradients
        (Megatron's f)."""
        return with_adjoint(x, torch.clone,
                            lambda g: self.all_reduce(g.clone()))

    def sum_replicated(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of `x`, which every rank then uses alike
        (its loss the same on every rank): the backward passes each
        rank's gradient through (Megatron's g, psum under shard_map)."""
        return with_adjoint(x, lambda t: self.all_reduce(t.clone()),
                            torch.clone)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's 1 / world_size of `x` (the same on every rank)
        along `dim`, for the rank to work on alone: the backward
        concatenates the ranks' gradients (Megatron's scatter)."""
        k = _part(x.shape[dim], self.world_size)
        return with_adjoint(
            x, lambda t: t.narrow(dim, self.rank * k, k).clone(),
            lambda g: self.concat(g, dim))

    def gather_replicated(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's `x` concatenated along `dim`, which every rank then
        uses alike: the backward keeps this rank's slice of the gradient
        (Megatron's gather)."""
        k = x.shape[dim]
        return with_adjoint(
            x, lambda t: self.concat(t, dim),
            lambda g: g.narrow(dim, self.rank * k, k).clone())

    def concat(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's `x` concatenated along `dim` (no gradient)."""
        return torch.cat(list(self.all_gather(x).unbind(0)), dim)

    @torch.no_grad()
    def sum_gradients(self, params) -> None:
        """Every parameter's .grad summed over the ranks (a missing one
        taken as zeros), in one flat all-reduce; on an N-D mesh one per
        axis, the innermost first (within a slice, then across the
        slices of a ('dcn', 'dp') mesh)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        if len(self.axis_names) == 1:
            self.all_reduce(flat)
        else:
            for name in reversed(self.axis_names):
                self.axis(name).all_reduce(flat)
        for p, g in zip(params, flat.split([g.numel() for g in grads])):
            p.grad = g.view_as(p)

    def gather_rows(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Every rank's `x` concatenated along `axis`, by an all-reduce of
        a zero-filled global buffer (x + 0 is x; only the sign of a zero
        may change)."""
        shape = list(x.shape)
        b = shape[axis]
        shape[axis] = b * self.world_size
        out = x.new_zeros(shape)
        out.narrow(axis, self.rank * b, b).copy_(x)
        return self.all_reduce(out)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(world_size, *x.shape): every rank's `x`, row r rank r's, by
        one broadcast of its bytes from each rank (no gradient)."""
        out = x.new_empty((self.world_size,) + tuple(x.shape))
        out[self.rank].copy_(x)
        if x.numel():
            for r in range(self.world_size):
                self.broadcast(_bytes(out[r]), r)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's row of the sum over the ranks of `x` (world_size,
        ...) (no gradient)."""
        if x.shape[0] != self.world_size:
            raise ValueError(f"reduce_scatter of {tuple(x.shape)} over "
                             f"{self.world_size} ranks")
        return self.all_reduce(x.clone())[self.rank]

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """`x` moved along `perm`, pairs (source, destination) of this
        mesh's ranks: each rank gets the x of the rank that sends to it,
        zeros where none does (lax.ppermute); one broadcast of its bytes
        from each source (no gradient)."""
        perm = sorted((int(s), int(d)) for s, d in perm)
        for idx in (0, 1):
            ends = [p[idx] for p in perm]
            if len(set(ends)) != len(ends) or not all(
                    0 <= r < self.world_size for r in ends):
                raise ValueError(f"{perm} is not a permutation of "
                                 f"{self.world_size} ranks")
        x = x.contiguous()
        out = torch.zeros_like(x)
        buf = torch.empty_like(x)
        for src, dst in perm:
            if src == self.rank:
                buf.copy_(x)
            if x.numel():
                self.broadcast(_bytes(buf), src)
            if dst == self.rank:
                out.copy_(buf)
        return out

    def all_gather_with_grad(self, x: torch.Tensor) -> torch.Tensor:
        """all_gather whose backward reduce-scatters: each rank gets the
        sum over the ranks of the gradients of its row."""
        return with_adjoint(x, self.all_gather, self.reduce_scatter)

    def reduce_scatter_with_grad(self, x: torch.Tensor) -> torch.Tensor:
        """reduce_scatter whose backward all-gathers."""
        return with_adjoint(x, self.reduce_scatter, self.all_gather)

    def ppermute_with_grad(self, x: torch.Tensor,
                           perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """ppermute whose backward moves the gradients along the inverse
        permutation."""
        inverse = [(d, s) for s, d in perm]
        return with_adjoint(x, lambda t: self.ppermute(t, perm),
                            lambda g: self.ppermute(g, inverse))

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`x` of the mesh's rank `src` on every rank, in place."""
        dist.broadcast(x, src=self.members[src] if self.members else src,
                       group=self.pg)
        return x

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        """`obj` of rank `src` on every rank, pickled into a byte tensor on
        the group's device (two broadcasts: the size, then the bytes)."""
        data = pickle.dumps(obj) if self.rank == src else b""
        size = torch.tensor([len(data)], dtype=torch.int64,
                            device=self.device)
        self.broadcast(size, src)
        buf = torch.zeros(int(size), dtype=torch.uint8, device=self.device)
        if self.rank == src:
            buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
        self.broadcast(buf, src)
        return obj if self.rank == src else pickle.loads(
            buf.cpu().numpy().tobytes())

    def barrier(self) -> None:
        dist.barrier(group=self.pg)

    def control(self) -> "Mesh":
        """A group of the same ranks for messages that may wait on a
        client: gloo on the CPU, its collectives given IDLE_TIMEOUT_S
        where the world's fail after INIT_TIMEOUT_S. Collective: every
        rank makes it, in the same order as its other groups."""
        pg = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=IDLE_TIMEOUT_S))
        return Mesh(self.world_size, self.rank, torch.device("cpu"), "gloo",
                    pg)


class _Adjoint(torch.autograd.Function):
    """forward(x) forward, backward(grad) backward: a collective with its
    adjoint (SyncBatchNorm's pattern; torch.distributed.nn.functional is
    deprecated, and the functional collectives carry no gradient). Every
    rank must reach the backward: a rank whose loss does not depend on
    the output still runs it with a zero gradient."""

    @staticmethod
    def forward(ctx, x, forward, backward):
        ctx.backward_fn = backward
        return forward(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.backward_fn(grad.contiguous()), None, None


def with_adjoint(x: torch.Tensor, forward: Callable,
                 backward: Callable) -> torch.Tensor:
    """forward(x), whose gradient is backward(the output's gradient)."""
    return _Adjoint.apply(x, forward, backward)


@dataclass(frozen=True)
class NodeLayout:
    """Spatial (node-axis) sharding of a (B, N, ...) block over `mesh`, the
    'sp' line (parallel/sharded.py, mode 'sp'): this rank holds node rows
    [rank * k, (rank + 1) * k) of N = k * mesh.world_size, and every
    (B, N, N, ...) pair tensor as its row block (B, k, N, ...). The
    forward's modules take it as `nodes` (None: the whole axis)."""

    mesh: Mesh
    k: int      # the rows this rank holds

    @property
    def n(self) -> int:
        """The whole node axis."""
        return self.k * self.mesh.world_size

    @property
    def rows(self) -> slice:
        start = self.mesh.rank * self.k
        return slice(start, start + self.k)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(B, k, ...) rows of every rank -> the whole (B, N, ...) axis
        (the j side of a pair op); its backward sends each rank the sum of
        the gradients of its rows. A tensor without a gradient (a mask)
        is gathered as bytes."""
        x = x.contiguous()
        stacked = (self.mesh.all_gather_with_grad(x) if x.is_floating_point()
                   else self.mesh.all_gather(x))
        return stacked.movedim(0, 1).reshape(
            (x.shape[0], self.n) + tuple(x.shape[2:]))

    def columns(self, partial: torch.Tensor) -> torch.Tensor:
        """This rank's rows (B, k, ...) of the sum over the ranks of a
        (B, N, ...) partial over the whole axis (each rank's column
        contributions); its backward gathers."""
        b = partial.shape[0]
        split = partial.reshape((b, self.mesh.world_size, self.k)
                                + tuple(partial.shape[2:]))
        return self.mesh.reduce_scatter_with_grad(
            split.movedim(1, 0).contiguous())


# the Mesh of this process's rank inside join(), its collectives' timeout,
# and the meshes made in it, by (axis names, sizes)
_CURRENT: list = [None]
_TIMEOUT: list = [INIT_TIMEOUT_S]
_MESHES: Dict[tuple, Mesh] = {}


def _world() -> Mesh:
    if _CURRENT[0] is None:
        raise RuntimeError("a mesh is made inside a rank of launch() or "
                           "join(); this process is in no world")
    return _CURRENT[0]


def _mesh(names: Tuple[str, ...], dims: Tuple[int, ...]) -> Mesh:
    """The world laid out row-major over `names` of sizes `dims`, with
    the process group of every line along one axis and, past two axes,
    along every axis but one. Collective: every rank makes every group,
    in the same order."""
    world = _world()
    if len(set(names)) != len(names):
        raise ValueError(f"mesh axis names {names} repeat")
    key = (names, dims)
    size = math.prod(dims)
    if size > world.world_size:
        raise ValueError(f"requested {size} devices, the world has "
                         f"{world.world_size} ranks")
    if key not in _MESHES:
        coords = list(itertools.product(*[range(d) for d in dims]))
        mine = coords[world.rank] if world.rank < size else None
        spans = [(a,) for a in range(len(dims))]
        if len(dims) > 2:
            spans += [tuple(b for b in range(len(dims)) if b != a)
                      for a in range(len(dims))]
        timeout = datetime.timedelta(seconds=_TIMEOUT[0])
        lines = {}
        for span in spans:
            fixed = [a for a in range(len(dims)) if a not in span]
            groups = {}
            for r, c in enumerate(coords):
                groups.setdefault(tuple(c[a] for a in fixed), []).append(r)
            for at, ranks in sorted(groups.items()):
                pg = dist.new_group(ranks, timeout=timeout)
                if mine is not None and at == tuple(mine[a] for a in fixed):
                    lines[tuple(names[a] for a in span)] = Mesh(
                        len(ranks), ranks.index(world.rank), world.device,
                        world.backend, pg, tuple(names[a] for a in span),
                        tuple(dims[a] for a in span), tuple(ranks))
        if size == world.world_size:
            mesh = dataclasses.replace(world, axis_names=names, dims=dims,
                                       lines=lines)
        else:
            # the first `size` ranks, as JAX's mesh takes jax.devices()[:n]
            pg = dist.new_group(list(range(size)), timeout=timeout)
            mesh = None if mine is None else Mesh(
                size, world.rank, world.device, world.backend, pg, names,
                dims, tuple(range(size)), lines)
        _MESHES[key] = mesh
    return _MESHES[key]


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "dp",
              dcn_slices: int = 1) -> Mesh:
    """This rank's mesh over the whole world that `launch` or `join`
    formed (num_devices, when given, must be its size): 1-D
    (axis_name,), or with dcn_slices > 1 the 2-D ('dcn', axis_name) mesh
    of multi-slice training, whose gradient sum runs within a slice, then
    across slices (Mesh.sum_gradients); the batch stays sharded over
    both axes."""
    group = _world()
    if num_devices is not None and num_devices != group.world_size:
        raise ValueError(f"requested {num_devices} devices, the world has "
                         f"{group.world_size} ranks")
    n = group.world_size
    if dcn_slices > 1:
        if n % dcn_slices:
            raise ValueError(f"{n} devices not divisible by {dcn_slices} "
                             f"slices")
        return _mesh(("dcn", axis_name), (dcn_slices, n // dcn_slices))
    if axis_name == group.axis_names[0]:
        return group
    return dataclasses.replace(group, axis_names=(axis_name,))


def make_hybrid_mesh(num_devices: int, model_parallel: int,
                     model_axis: str = "fsdp",
                     data_axis: str = "dp") -> Optional[Mesh]:
    """A (data_axis, model_axis) mesh over the first num_devices ranks of
    the world (JAX's takes jax.devices()[:num_devices]): num_devices = dp
    * model_parallel ranks, the model axis the inner one (ranks 2i and
    2i + 1 share a model line at model_parallel 2). Collective over the
    world; a rank past num_devices gets None."""
    if num_devices % model_parallel:
        raise ValueError(f"{num_devices} devices not divisible by "
                         f"model_parallel={model_parallel}")
    return _mesh((data_axis, model_axis),
                 (num_devices // model_parallel, model_parallel))


def batch_sharding(group: Mesh, batch_size: int) -> slice:
    """The rows of a batch of `batch_size` graphs this rank holds (the
    graph axis sharded over the group)."""
    return group.rows(batch_size)


def replicated(group: Mesh) -> slice:
    """Every row: parameters and their optimizer state on every rank."""
    return slice(None)


@contextlib.contextmanager
def join(rank: int, world_size: int, port: int, backend: str, device,
         timeout_s: Optional[float] = None):
    """Join the world of `world_size` ranks that meets at 127.0.0.1:port
    as `rank` on `device`, yield its Mesh, and leave it. Its rendezvous
    and its collectives fail after timeout_s (INIT_TIMEOUT_S)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s or INIT_TIMEOUT_S))
    _CURRENT[0] = Mesh(world_size, rank, device, backend)
    _TIMEOUT[0] = timeout_s or INIT_TIMEOUT_S
    try:
        yield _CURRENT[0]
    finally:
        _CURRENT[0] = None
        _MESHES.clear()
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def placement(num_devices: int, device=None, backend: Optional[str] = None):
    """(each rank's device, backend). None or 'cuda': rank r on cuda:r,
    NCCL by default, at most the machine's cards; 'cuda:<i>': every rank
    on that card (more than one needs gloo: NCCL refuses two ranks on one
    device); 'cpu': gloo."""
    if num_devices < 1:
        raise ValueError(f"num_devices={num_devices}: at least one rank")
    device = torch.device(device or "cuda")
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"{backend} does not run on the CPU; use gloo")
        return ["cpu"] * num_devices, "gloo"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device.index is None:
        if num_devices > cards:
            raise ValueError(f"requested {num_devices} devices, have "
                             f"{cards} CUDA cards")
        return ([f"cuda:{r}" for r in range(num_devices)],
                backend or "nccl")
    if device.index >= cards:
        raise ValueError(f"requested {device}, have {cards} CUDA cards")
    backend = backend or ("nccl" if num_devices == 1 else "gloo")
    if backend == "nccl" and num_devices > 1:
        raise ValueError("NCCL refuses two ranks on one device; use gloo")
    return [str(device)] * num_devices, backend


def _rank_main(rank, fn, args, world_size, port, devices, backend,
               threads, timeout_s, result_path):
    if devices[rank] == "cpu":
        torch.set_num_threads(threads)
    with join(rank, world_size, port, backend, devices[rank],
              timeout_s) as group:
        result = fn(group, *args)
        if rank == 0:
            torch.save(result, result_path)
        # no rank leaves while another may still call a collective
        group.barrier()


def launch(fn: Callable, num_devices: int, *args, device=None,
           backend: Optional[str] = None) -> Any:
    """Run fn(group, *args) on `num_devices` spawned ranks and return rank
    0's result (torch.save-able). `fn` must be importable (a module-level
    function). Raises, in this process, when the machine lacks the cards,
    when the process group cannot form, or when any rank fails."""
    devices, backend = placement(num_devices, device, backend)
    threads = max(1, torch.get_num_threads() // num_devices)
    with tempfile.TemporaryDirectory(prefix="agdiff_dp_") as tmp:
        path = os.path.join(tmp, "rank0.pt")
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, args, num_devices, free_port(), devices,
                              backend, threads, INIT_TIMEOUT_S, path),
            nprocs=num_devices, join=True, start_method="spawn")
        return torch.load(path, weights_only=False)
