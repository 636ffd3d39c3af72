"""Unordered-pair lists: the full upper triangle of a bucket, or a tight
list of one molecule's real pairs (port of agdiff_tpu/ops/pairs.py and of
the pair machinery of agdiff_tpu/models/tight_forward.py:54-129).

Every per-edge quantity of the working graph is symmetric in (i, j), so a
list of pairs i < j carries all of it:

* `triu_pairs(n)`: all N(N-1)/2 pairs of the bucket in
  `np.triu_indices(n, 1)` order; every slot is valid.
* `prepare_pairs(node_mask, capacity)`: the pairs of real atoms, in
  row-major order, padded to a static `capacity` with pad slots. A pad
  slot has valid 0, both endpoints at node 0 (so every gather stays in
  bounds), and writes no dense cell when a plane is mirrored back.

A list is shared (one list for the whole batch: fields without a batch
axis, the generation pattern of one molecule repeated) or per graph
(a leading batch axis on every field). A shared list also holds the
per-node incidence lists K1 aggregates over: for node n, the valid pairs
that touch it in increasing pair order, each with the pair's other
endpoint, packed into one 32-bit entry (pair << inc_shift | other).
Summing a node's messages in that fixed order needs no atomics and
reproduces run to run. A pad slot is in no node's list.

Under spatial sharding (a NodeLayout, parallel/mesh.py, mode 'sp') the
packed layout runs on `owned_pairs`: each rank's share of the triangle,
every pair owned by exactly one rank, the one whose node rows hold its
endpoint i, with the ranks' loads equal within N (`pair_owners`). The
four free functions below (pack_plane, gather_endpoints,
scatter_add_endpoints, mirror_plane) take such a share in place of a
PairList and return the rank's blocks.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, fields
from typing import Any, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class PairList:
    idx: torch.Tensor        # ([B,] P) int64 flat cell i*N + j (pad: 0)
    valid: torch.Tensor      # ([B,] P) float32, 1 for real pairs
    iu: torch.Tensor         # ([B,] P) int64 endpoint i (i < j; pad: 0)
    ju: torch.Tensor         # ([B,] P) int64 endpoint j (pad: 0)
    slot: torch.Tensor       # ([B,] N*N) int64 dense cell -> slot (else 0)
    inc_ptr: Optional[torch.Tensor] = None    # (N + 1,) int32 CSR offsets
    inc: Optional[torch.Tensor] = None   # (2V,) 32-bit entries, as int32:
                                         # pair << inc_shift | other
    inc_shift: int = 1       # bits of the other endpoint in an entry
    tight: bool = False      # a molecule's list, not the bucket's triangle
    num_valid: int = 0       # V; valid slots come first (the largest V
                             # of the batch for a per-graph list)
    key: tuple = ()          # the list's identity from its host data:
                             # equal keys, equal lists (a CUDA graph
                             # captured on one list replays only for it)

    @property
    def shared(self) -> bool:
        return self.iu.dim() == 1

    @property
    def num_pairs(self) -> int:
        return self.iu.shape[-1]

    @property
    def num_nodes(self) -> int:
        return int(round(self.slot.shape[-1] ** 0.5))

    @property
    def inc_pair(self) -> torch.Tensor:
        """(2V,) the incident pair of each entry, increasing per node."""
        return (self.inc.long() & 0xFFFFFFFF) >> self.inc_shift

    @property
    def inc_other(self) -> torch.Tensor:
        """(2V,) the pair's other endpoint."""
        return self.inc.long() & ((1 << self.inc_shift) - 1)

    @property
    def pair_id(self) -> torch.Tensor:
        """The slot map as ([B,] N, N)."""
        n = self.num_nodes
        return self.slot.reshape(*self.slot.shape[:-1], n, n)

    def to(self, device) -> "PairList":
        moved = {f.name: getattr(self, f.name) for f in fields(self)}
        for k, v in moved.items():
            if isinstance(v, torch.Tensor):
                moved[k] = v.to(device)
        return PairList(**moved)


def incidence(iu: np.ndarray, ju: np.ndarray, n: int):
    """CSR incidence lists of a pair list: per node, (pair, other endpoint)
    sorted by pair index."""
    p = np.arange(len(iu))
    node = np.concatenate([iu, ju])
    pair = np.concatenate([p, p])
    other = np.concatenate([ju, iu])
    order = np.lexsort((pair, node))
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(node, minlength=n), out=ptr[1:])
    return (ptr.astype(np.int32), pair[order].astype(np.int32),
            other[order].astype(np.int32))


def _shared_list(iu, ju, n, capacity, tight, device) -> PairList:
    """A shared list from its V valid pairs (i < j), padded to capacity."""
    v = len(iu)
    pad = capacity - v
    ptr, pair, other = incidence(iu, ju, n)
    shift = max(1, (n - 1).bit_length())
    if v and (v - 1) >> (32 - shift):
        raise ValueError(f"{v} pairs of {n} nodes exceed 32-bit incidence "
                         f"entries")
    inc = ((pair.astype(np.uint64) << shift) | other.astype(np.uint64))
    slot = np.zeros((n, n), np.int64)
    slot[iu, ju] = np.arange(v)
    slot[ju, iu] = np.arange(v)
    digest = hashlib.blake2b(np.stack([iu, ju]).astype(np.int64).tobytes(),
                             digest_size=8).hexdigest()
    iu_p = np.concatenate([iu, np.zeros(pad, np.int64)])
    ju_p = np.concatenate([ju, np.zeros(pad, np.int64)])
    return PairList(
        idx=torch.from_numpy(iu_p * n + ju_p),
        valid=torch.from_numpy((np.arange(capacity) < v).astype(np.float32)),
        iu=torch.from_numpy(iu_p), ju=torch.from_numpy(ju_p),
        slot=torch.from_numpy(slot.reshape(-1)),
        inc_ptr=torch.from_numpy(ptr),
        inc=torch.from_numpy(inc.astype(np.uint32).view(np.int32)),
        inc_shift=shift, tight=tight, num_valid=v,
        key=("tight" if tight else "triu", n, capacity, v, shift, digest),
    ).to(device)


def triu_pairs(n: int, device="cpu") -> PairList:
    iu, ju = np.triu_indices(n, k=1)
    return _shared_list(iu.astype(np.int64), ju.astype(np.int64), n,
                        len(iu), False, device)


def pair_capacity_for(num_nodes: int, multiple: int = 64) -> int:
    """Static pair capacity for graphs of at most num_nodes real atoms,
    rounded up to `multiple` (fewer distinct shapes)."""
    n = int(num_nodes)
    cap = n * (n - 1) // 2
    return max(multiple, -(-cap // multiple) * multiple)


def _real_pairs(mask: np.ndarray):
    iu, ju = np.triu_indices(len(mask), k=1)
    keep = mask[iu] & mask[ju]
    return iu[keep].astype(np.int64), ju[keep].astype(np.int64)


def prepare_pairs_shared(node_mask, capacity: int) -> PairList:
    """Graph 0's tight list, for a batch of one molecule repeated (its
    node set covers every graph's). Built on the host, once per ladder."""
    mask = node_mask[0].cpu().numpy().astype(bool)
    iu, ju = _real_pairs(mask)
    if len(iu) > capacity:
        raise ValueError(f"{len(iu)} real pairs exceed capacity {capacity}")
    return _shared_list(iu, ju, len(mask), capacity, True,
                        node_mask.device)


def prepare_pairs(node_mask, capacity: int) -> PairList:
    """Per-graph tight lists, (B, capacity) each (no incidence lists: the
    kernel takes shared lists only)."""
    b, n = node_mask.shape
    lists = [prepare_pairs_shared(node_mask[k:k + 1].cpu(), capacity)
             for k in range(b)]
    stacked = {f: torch.stack([getattr(pl, f) for pl in lists])
               for f in ("idx", "valid", "iu", "ju", "slot")}
    return PairList(**stacked, tight=True,
                    num_valid=max(pl.num_valid for pl in lists),
                    key=("per-graph",) + tuple(pl.key for pl in lists)
                    ).to(node_mask.device)


def _flat(index, b: int, stride: int):
    """([B,] K) per-graph index -> (B, K) index into the (B * stride)
    flattening of a batched tensor."""
    base = torch.arange(b, device=index.device)[:, None] * stride
    return index + base


def pack_plane(a, pairs: PairList):
    """(B, N, N[, C]) symmetric -> (B, P[, C]) at the list's cells (a
    rank's row block (B, k, N[, C]) at its owned pairs' cells)."""
    if isinstance(pairs, OwnedPairs):
        return pairs.pack(a)
    b, n = a.shape[:2]
    flat = a.reshape(b * n * n, *a.shape[3:])
    return flat[_flat(pairs.idx, b, n * n)]


def gather_nodes(x, index):
    """(B, N, F) node rows at a ([B,] P) endpoint index -> (B, P, F)."""
    b, n = x.shape[:2]
    return x.reshape(b * n, -1)[_flat(index, b, n)]


def scatter_nodes(out, index, msg):
    """out (B, N, F) += msg (B, P, F) summed onto the endpoints `index`."""
    b, n = out.shape[:2]
    out.view(b * n, -1).index_add_(0, _flat(index, b, n).reshape(-1),
                                   msg.reshape(-1, msg.shape[-1]))
    return out


def mirror_plane(s, pairs: PairList):
    """(B, P) packed symmetric plane -> (B, N, N). Cells outside the list
    (the diagonal, padded nodes) get slot 0's value: every consumer masks
    them. A rank's owned pairs give its row block (B, k, N), the diagonal
    0."""
    if isinstance(pairs, OwnedPairs):
        return pairs.mirror(s)
    b, p = s.shape
    n = pairs.num_nodes
    return s.reshape(-1)[_flat(pairs.slot, b, p)].reshape(b, n, n)


def mirror_features(e, pairs: PairList):
    """(B, P, C) packed symmetric features -> (B, N, N, C) on a shared
    list (the JAX engine's e_packed[:, pair_id]). Cells outside the list
    (the diagonal, padded nodes) get slot 0's row, as there: every
    consumer weights or masks them to zero."""
    if not pairs.shared:
        raise ValueError("mirror_features takes a shared pair list")
    b, _, c = e.shape
    n = pairs.num_nodes
    return e[:, pairs.slot].reshape(b, n, n, c)


def _selectors(pairs: PairList, dtype):
    """The (P, N) 0/1 endpoint selectors of a shared list."""
    n = pairs.num_nodes
    return (torch.nn.functional.one_hot(pairs.iu, n).to(dtype),
            torch.nn.functional.one_hot(pairs.ju, n).to(dtype))


def gather_endpoints(x, pairs: PairList):
    """(B, N, F) node rows -> ((B, P, F) at endpoint i, (B, P, F) at j) of
    a shared list (agdiff_tpu/ops/pairs.py:70-72), through the endpoint
    selectors: the rows exactly, and a backward that sums each node's
    pairs in a product. (On a card the backward of x[:, iu], PyTorch's
    indexing_backward_kernel, put a train step's gradients 1e-4 of their
    scale off the dense layout's; this one stays within 5e-6.) The
    products run in float32 and round to x's dtype once, so that the
    backward's sums over the pairs accumulate in float32 at bf16 too, as
    JAX's einsum accumulates them (scatter_add_endpoints). On a rank's
    owned pairs x is its node rows (B, k, F), and j's rows come from the
    whole axis."""
    if isinstance(pairs, OwnedPairs):
        return pairs.endpoints(x)
    oh_i, oh_j = _selectors(pairs, torch.float32)
    xf = x.float()
    return (torch.einsum("pn,bnf->bpf", oh_i, xf).to(x.dtype),
            torch.einsum("pn,bnf->bpf", oh_j, xf).to(x.dtype))


def scatter_add_endpoints(msg_i, msg_j, pairs: PairList):
    """Per-pair messages summed onto their endpoints, (B, P, F) x 2 ->
    (B, N, F): msg_i lands on endpoint i, msg_j on endpoint j. Through the
    endpoint selectors, as the JAX package sums them (agdiff_tpu/ops/
    pairs.py:75-81): a product, with no atomics, so the sum and its
    gradient repeat bit for bit. Each product sums in float32 and rounds
    to the messages' dtype once: a bf16 GEMM may reduce in reduced
    precision (cuBLAS's split-K over P, 32640 pairs at N=256, moved a
    bf16 step's BatchNorm statistics 7.8e-3), where JAX's einsum
    accumulates in float32. On a rank's owned pairs the result is the
    rank's rows (B, k, F) of every rank's messages."""
    if isinstance(pairs, OwnedPairs):
        return pairs.scatter(msg_i, msg_j)
    oh_i, oh_j = _selectors(pairs, torch.float32)
    return (torch.einsum("bpf,pn->bnf", msg_i.float(), oh_i).to(msg_i.dtype)
            + torch.einsum("bpf,pn->bnf", msg_j.float(), oh_j).to(
                msg_j.dtype))


def pair_owners(n: int):
    """(i, j): every unordered pair of n nodes once, as (owner endpoint,
    other endpoint), cyclically: node i owns (i, (i + d) mod n) for d = 1
    .. ceil((n - 1) / 2), and each pair at d = n / 2 (n even) goes to one
    of its two nodes, i < n / 2 when i is even, else i + n / 2. Every node
    owns (n - 1) // 2 or n // 2 pairs, so a rank's k rows hold P / sp
    pairs within k."""
    iu, ju = np.triu_indices(n, k=1)
    d = ju - iu
    flip = (2 * d > n) | ((2 * d == n) & (iu % 2 == 1))
    return (np.where(flip, ju, iu).astype(np.int64),
            np.where(flip, iu, ju).astype(np.int64))


@dataclass(frozen=True)
class OwnedPairs:
    """This rank's share of the triangle under a node layout `nodes`
    (parallel/mesh.py NodeLayout): the pairs whose owner endpoint i lies in
    its rows (pair_owners), sorted by (i, j). The packed per-edge tensors
    are then (B, P_r, ...) on them: i's side reads the rank's own node
    rows, j's side the gathered axis. The messages to i stay on the rank
    (every pair of a node as i is its owner's); those to j, and the score
    planes at (i, j) and (j, i), go into a (B, N, ...) partial over the
    whole axis whose reduce-scatter (NodeLayout.columns) gives each rank
    its rows: one collective a message layer and a plane. Selections and
    sums run in float32 through one-hot selectors built once a forward; a
    node's messages are summed in two parts, those it receives as the
    lower endpoint of a pair and as the higher, each rounded to the
    compute dtype once before the two are added, as the one-process
    packed layout's two products (scatter_add_endpoints) round them."""

    nodes: Any
    i: torch.Tensor       # (P_r,) int64 owner endpoint, global index
    j: torch.Tensor       # (P_r,) int64 other endpoint, global index
    cell: torch.Tensor    # (P_r,) int64 cell (i - row0) * N + j of the block
    sel_i: torch.Tensor   # (P_r, k) float32 one-hot of i among the rows
    sel_j: torch.Tensor   # (P_r, N) float32 one-hot of j
    # one-hots of (i among the rows, the part) and (j, the part), the part
    # 0 where the node is the pair's lower endpoint, 1 where the higher
    to_i: torch.Tensor    # (P_r, 2k) float32
    to_j: torch.Tensor    # (P_r, 2N) float32

    @property
    def num_pairs(self) -> int:
        return self.i.shape[0]

    def pack(self, a):
        """(B, k, N[, C]) row block -> (B, P_r[, C])."""
        b = a.shape[0]
        return a.reshape(b, -1, *a.shape[3:])[:, self.cell]

    def endpoints(self, x):
        """(B, k, F) node rows -> (x_i, x_j), each (B, P_r, F): x_i from the
        rank's rows, x_j from every rank's (NodeLayout.gather)."""
        xf = x.float()
        return (torch.einsum("pn,bnf->bpf", self.sel_i, xf).to(x.dtype),
                torch.einsum("pn,bnf->bpf", self.sel_j,
                             self.nodes.gather(xf)).to(x.dtype))

    def scatter(self, msg_i, msg_j):
        """msg_i onto endpoint i and msg_j onto j, summed over every
        rank's pairs: this rank's rows (B, k, F)."""
        b, f = msg_i.shape[0], msg_i.shape[-1]
        own = torch.einsum("bpf,pn->bnf", msg_i.float(), self.to_i)
        partial = torch.einsum("bpf,pn->bnf", msg_j.float(), self.to_j)
        parts = (own.view(b, -1, 2, f) + self.nodes.columns(
            partial.view(b, -1, 2, f))).to(msg_i.dtype)
        return parts[:, :, 0] + parts[:, :, 1]

    def mirror(self, s):
        """(B, P_r) symmetric scores -> this rank's row block (B, k, N) of
        the plane every rank's pairs fill at (i, j) and (j, i); the
        diagonal is 0 (every consumer masks it)."""
        b, n = s.shape[0], self.nodes.n
        cells = torch.cat([self.i * n + self.j, self.j * n + self.i])
        partial = s.new_zeros((b, n * n), dtype=torch.float32).index_add(
            1, cells, torch.cat([s, s], 1).float())
        return self.nodes.columns(partial.view(b, n, n)).to(s.dtype)


def owned_pairs(nodes, device) -> OwnedPairs:
    """This rank's OwnedPairs under the node layout `nodes`, built on the
    host."""
    i, j = pair_owners(nodes.n)
    start = nodes.rows.start
    mine = (i >= start) & (i < start + nodes.k)
    i, j = i[mine], j[mine]
    order = np.lexsort((j, i))
    i = torch.from_numpy(i[order]).to(device)
    j = torch.from_numpy(j[order]).to(device)
    one_hot = torch.nn.functional.one_hot
    flip = (i > j).long()
    return OwnedPairs(nodes=nodes, i=i, j=j, cell=(i - start) * nodes.n + j,
                      sel_i=one_hot(i - start, nodes.k).float(),
                      sel_j=one_hot(j, nodes.n).float(),
                      to_i=one_hot(2 * (i - start) + flip,
                                   2 * nodes.k).float(),
                      to_j=one_hot(2 * j + 1 - flip, 2 * nodes.n).float())
