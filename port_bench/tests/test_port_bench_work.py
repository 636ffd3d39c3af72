"""The benchmark's FLOP and byte counts at a tiny shape, against numbers
worked out by hand."""

import numpy as np

from port_bench import chem
from port_bench.work import agdiff as work

CFG = {"hidden_dim": 16, "num_convs": 1, "num_convs_local": 1}


def test_local_pairs_of_a_chain():
    # a chain of 5 atoms: pairs within 3 bonds are 4 + 3 + 2 = 9
    mol = {"atom_type": np.ones(5, np.int32),
           "bonds": np.array([[0, 1], [1, 2], [2, 3], [3, 4]])}
    assert work.local_pairs(chem.adjacency(mol), 3) == 9
    assert work.local_pairs(chem.adjacency(mol), 1) == 4


def test_forward_flops_by_hand():
    # H = 16, one SchNet block, one GIN layer; n = 4 atoms, P = 6, L = 5
    n, p, l, h = 4, 6, 5, 16
    edge = p * (2 * h + 12 * h * h)                       # 37056
    conv = 0
    for f in (16, 8):
        conv += p * (2 * h * f + 2 * f * f + 128) + p * 4 * f \
            + n * 4 * h * f
    # conv1: 6 * (512 + 512 + 128) + 384 + 4096 = 11392
    # conv2: 6 * (256 + 128 + 128) + 192 + 2048 = 5312
    assert conv == 11392 + 5312
    node = n * 2 * (2 * h * h + h * 8 + 8 + 2 * h * 1)    # 5440
    gin = l * 4 * h + n * 4 * h * h                       # 320 + 4096
    head = h + 2 * (2 * h * h + h * 8 + 8)                # 1312
    k1 = conv + node + gin + (p + l) * head
    assert k1 == 16704 + 5440 + 4416 + 11 * 1312
    got = work.forward(n, p, l, CFG, 2)
    assert got.flops == edge + k1
    assert work.k1(n, p, l, CFG, 2).flops == k1


def test_k1_bytes_by_hand():
    n, p, l, h = 4, 6, 5, 16
    # edge features (bf16) and distances of P pairs, the L-pair mask,
    # two (n, H) embeddings, two float32 score planes
    want = p * (h * 2 + 4) + l + 2 * n * h * 2 + (p + l) * 4
    assert work.k1(n, p, l, CFG, 2).bytes == want == 216 + 5 + 256 + 44
    # weights: conv(16) 16*16*4 + 96, conv(8) 16*8 + 64 + 128 + 128 + 96,
    # the block's 2 H^2 + H * H/2 + 2 H * H/16, GIN 2 H^2, two heads
    conv16 = 4 * 256 + 96
    conv8 = 128 + 64 + 128 + 128 + 96
    block = conv16 + conv8 + 512 + 128 + 32
    heads = 2 * (512 + 128 + 8)
    assert work.k1_weights(CFG, 2) == (block + 512 + heads) * 2


def test_work_scales_with_count():
    w = work.forward(4, 6, 5, CFG, 2)
    assert w.scale(3).flops == 3 * w.flops
    assert (w + w).bytes == 2 * w.bytes
