"""Data-parallel groups over torch.distributed (port of
agdiff_tpu/parallel/mesh.py:26-58).

The JAX package builds a 1-D ('dp',) device mesh inside one process and
lets XLA's SPMD partitioner insert the collectives. Here a group is one
process a device: `launch` spawns N ranks (torch.multiprocessing, spawn
context), each joins one process group (NCCL on the cards, gloo on the
CPU) and runs the caller's function with its `Mesh`: world size, rank,
device and backend. Parameters are replicated on every rank, the graph
axis of each batch is split into equal contiguous shards
(parallel/data_parallel.py), and the arithmetic that crosses ranks uses
three collectives only, `all_reduce`, `broadcast` and `barrier`: gloo
supports no others on CUDA tensors, and NCCL takes no CPU tensors. A
rank's rows are gathered by an all-reduce of a zero-filled global buffer
into which each rank wrote its own. Every collective of a world fails
after INIT_TIMEOUT_S, so a hung world fails; a message that may wait on
a client (a server's next request) goes through a control group
(`Mesh.control`) that waits as long as a server stays up.

`launch(..., device="cuda:0", backend="gloo")` puts every rank on one
card (NCCL refuses two ranks on one device): the cross-rank arithmetic
on a one-card machine. Asking for more cards than the machine has
raises, a failed initialisation raises, and a rank that dies fails the
whole run (the others are terminated): there is no fallback to fewer
devices. A multi-slice mesh (dcn_slices > 1) is not ported (ROADMAP.md
queue 1 item 7c).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import socket
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

INIT_TIMEOUT_S = 60.0   # rendezvous and every collective: a hung world fails
# a control group's collectives: a server's follower waits in one for the
# next client, however long that takes
IDLE_TIMEOUT_S = 365 * 86400.0

DCN_REFUSAL = ("dcn_slices > 1: a multi-slice ('dcn', 'dp') mesh is not "
               "ported (ROADMAP.md queue 1 item 7c)")


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a data-parallel group: the default process
    group of its world, or `pg`, a group of the same ranks."""

    world_size: int
    rank: int
    device: torch.device
    backend: str
    pg: Any = None

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes files and logs."""
        return self.rank == 0

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
        return _AllReduceSum.apply(x, self)

    @torch.no_grad()
    def sum_gradients(self, params) -> None:
        """Every parameter's .grad summed over the ranks (a missing one
        taken as zeros), in one flat all-reduce."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        flat = self.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
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

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(x, src=src, group=self.pg)
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


class _AllReduceSum(torch.autograd.Function):
    """SUM forward, SUM of the gradients backward (SyncBatchNorm's
    pattern). torch.distributed.nn.functional.all_reduce is deprecated,
    and the functional collectives carry no gradient."""

    @staticmethod
    def forward(ctx, x, group: Mesh):
        ctx.group = group
        return group.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.clone()), None


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "dp",
              dcn_slices: int = 1) -> Mesh:
    """This rank's group, inside a world that `launch` or `join` formed;
    num_devices, when given, must be the world's size. axis_name is
    accepted for the JAX signature: a group has one axis."""
    if dcn_slices > 1:
        raise NotImplementedError(DCN_REFUSAL)
    group = _CURRENT[0]
    if group is None:
        raise RuntimeError("make_mesh runs inside a rank of launch() or "
                           "join(); this process is in no world")
    if num_devices is not None and num_devices != group.world_size:
        raise ValueError(f"requested {num_devices} devices, the world has "
                         f"{group.world_size} ranks")
    return group


def batch_sharding(group: Mesh, batch_size: int) -> slice:
    """The rows of a batch of `batch_size` graphs this rank holds (the
    graph axis sharded over the group)."""
    return group.rows(batch_size)


def replicated(group: Mesh) -> slice:
    """Every row: parameters and their optimizer state on every rank."""
    return slice(None)


# the Mesh of this process's rank inside join()
_CURRENT: list = [None]


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
    try:
        yield _CURRENT[0]
    finally:
        _CURRENT[0] = None
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
