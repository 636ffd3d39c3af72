"""The reference against agdiff_torch's dense module (float32) on the
CPU at a tiny size, with the benchmark's seeded weights, for both
configurations' envelopes and both head activations."""

import numpy as np
import pytest
import torch

from port_bench import chem
from port_bench.reference import agdiff as ref
from port_bench.weights import make_weights


def _batch(mols, bucket):
    from agdiff_torch.data.bucketing import pad_molecules
    from port_bench.traffic.testset import program_molecule

    return pad_molecules([program_molecule(m) for m in mols], bucket,
                         edge_order=3)


@pytest.mark.parametrize("smooth,act", [(False, "relu"), (True, "gelu")])
def test_reference_matches_dense_module(smooth, act):
    from agdiff_torch.config import ModelConfig
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork

    cfg = dict(hidden_dim=32, num_convs=2, num_convs_local=2, cutoff=10.0,
               smooth_conv=smooth, mlp_act=act, embedding_max_norm=10.0)
    module = DualEncoderEpsNetwork(ModelConfig(
        hidden_dim=32, num_convs=2, num_convs_local=2, smooth_conv=smooth,
        mlp_act=act))
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    w = make_weights(shapes, 2 ** 31 + 7, "cpu")
    module.load_state_dict(w)
    module.eval()
    rng = np.random.default_rng(0)
    mols = [chem.tree_molecule(rng, h) for h in (4, 7, 9)]
    batch = _batch(mols, 32)
    adj = np.zeros((3, 32, 32), np.int64)
    for k, m in enumerate(mols):
        n = len(m["atom_type"])
        adj[k, :n, :n] = ref.extend_bond_order(chem.adjacency(m))
    assert np.array_equal(adj, batch.bond_adj.numpy())
    with torch.no_grad():
        out = module(batch)
        g, loc, em, lm, d = ref.Model(w, cfg).forward(
            batch.atom_type, batch.pos, batch.node_mask, torch.from_numpy(adj))
    assert torch.equal(em, out.edge_mask) and torch.equal(lm, out.local_mask)
    for got, want, mask in ((g, out.edge_inv_global, em),
                            (loc, out.edge_inv_local, lm)):
        scale = float(want[mask].abs().max())
        assert float((got - want)[mask].abs().max()) <= 1e-5 * scale


def test_tree_molecules_have_their_sizes():
    rng = np.random.default_rng(3)
    for heavy in (4, 9):
        m = chem.tree_molecule(rng, heavy)
        atoms = len(m["atom_type"])
        assert (m["atom_type"] != 1).sum() == heavy
        assert atoms == len(m["pos"])
        assert len(m["bonds"]) == atoms - 1     # a tree
