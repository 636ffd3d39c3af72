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
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, fields
from typing import Optional

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
    """(B, N, N[, C]) symmetric -> (B, P[, C]) at the list's cells."""
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
    them."""
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
    scale off the dense layout's; this one stays within 5e-6.)"""
    oh_i, oh_j = _selectors(pairs, x.dtype)
    return (torch.einsum("pn,bnf->bpf", oh_i, x),
            torch.einsum("pn,bnf->bpf", oh_j, x))


def scatter_add_endpoints(msg_i, msg_j, pairs: PairList):
    """Per-pair messages summed onto their endpoints, (B, P, F) x 2 ->
    (B, N, F): msg_i lands on endpoint i, msg_j on endpoint j. Through the
    endpoint selectors, as the JAX package sums them (agdiff_tpu/ops/
    pairs.py:75-81): a product, with no atomics, so the sum and its
    gradient repeat bit for bit."""
    oh_i, oh_j = _selectors(pairs, msg_i.dtype)
    return (torch.einsum("bpf,pn->bnf", msg_i, oh_i)
            + torch.einsum("bpf,pn->bnf", msg_j, oh_j))
