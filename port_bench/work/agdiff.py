"""Operations and bytes of AGDIFF's eval forward, counted from the
configuration's widths and a molecule's real atoms and pairs, whatever
implements it.

One forward of one molecule with n atoms works on:
- P pairs of its working graph, the radius graph at the cutoff united
  with the order-3 bond graph. Positions move along the ladder, so P is
  counted as its upper bound, every pair of distinct atoms, n(n-1)/2;
- L pairs of the order-3 bond graph (the local pairs), from the bonds.
Pairs are unordered: every per-pair quantity of the model is symmetric,
so the work on (i, j) and (j, i) is done once.

FLOPs count the matrix products at 2 per multiply-add, and the message
sums at 2 per pair, direction and channel (a product and an add); the
activations, normalisations, gathers and the edge encoder's attention
(a softmax over one entry, exactly 1) are not counted. Bytes count each
input read once and each output written once at the configuration's
dtype (activations `act_bytes` each, the score planes float32), weights
once per launch.

`forward(n, P, L, cfg)` is the whole forward; `k1(...)` the part that
the program's whole-stack kernel does (both encoders' layers after the
edge encoder and the embeddings, and both score heads), whose least time
is the roofline numerator.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Work(NamedTuple):
    flops: float
    bytes: float

    def __add__(self, other):
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def scale(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)


def local_pairs(adj: np.ndarray, order: int = 3) -> int:
    """Unordered atom pairs within `order` bonds of each other."""
    one = ((adj > 0) | np.eye(len(adj), dtype=bool)).astype(np.int64)
    reach = one
    for _ in range(order - 1):
        reach = ((reach @ one) > 0).astype(np.int64)
    return int((reach.sum() - len(adj)) // 2)


def _flops(n: int, p: int, l: int, h: int, nb: int, nl: int):
    """(edge encoder and embeddings, K1's share) FLOPs of one forward."""
    edge = p * 2 * (h + 2 * h * h + h * h + 2 * h * h + h * h)
    f1, f2 = h, h // 2
    conv = 0
    for f in (f1, f2):
        conv += p * 2 * (h * f + f * f + 32 + 32)     # filter MLP, weights
        conv += p * 2 * 2 * f                         # messages, both ways
        conv += n * 2 * (h * f + f * h)               # lin1, lin2
    block = conv + n * 2 * (2 * h * h + h * (h // 2) + h // 2
                            + 2 * h * (h // 16))
    gin = l * 2 * 2 * h + n * 2 * 2 * h * h
    head = h + 2 * (2 * h * h + h * (h // 2) + h // 2)
    k1 = nb * block + nl * gin + (p + l) * head
    return edge, k1


def _k1_weights(h: int, nb: int, nl: int) -> int:
    f2 = h // 2
    conv = lambda f: h * f + f * f + h * f + f * h + 3 * 32   # noqa: E731
    block = conv(h) + conv(f2) + 2 * h * h + h * (h // 2) + 2 * h * (h // 16)
    head = 2 * h * h + h * (h // 2) + h // 2
    return nb * block + nl * 2 * h * h + 2 * head


def forward(n: int, p: int, l: int, cfg: dict, act_bytes: int) -> Work:
    h = cfg["hidden_dim"]
    edge, k1 = _flops(n, p, l, h, cfg["num_convs"], cfg["num_convs_local"])
    # in: positions, atom types, the order-3 adjacency's L pairs; out: the
    # two score planes
    nbytes = n * 3 * 4 + n * 4 + l * 4 + (p + l) * 4
    return Work(edge + k1, nbytes)


def k1(n: int, p: int, l: int, cfg: dict, act_bytes: int) -> Work:
    """K1's work for one molecule, its weights excluded (`k1_weights`)."""
    h = cfg["hidden_dim"]
    _, flops = _flops(n, p, l, h, cfg["num_convs"], cfg["num_convs_local"])
    # in: edge features and distances of the P pairs, the local mask of
    # the L pairs, both encoders' node embeddings; out: two score planes
    nbytes = p * (h * act_bytes + 4) + l + 2 * n * h * act_bytes \
        + (p + l) * 4
    return Work(flops, nbytes)


def k1_weights(cfg: dict, act_bytes: int) -> float:
    """Bytes of the weights K1 reads once a launch."""
    return _k1_weights(cfg["hidden_dim"], cfg["num_convs"],
                       cfg["num_convs_local"]) * act_bytes
