"""Ensemble properties: energy, HOMO, LUMO and dipole moment (port of
agdiff_tpu/eval/properties.py; reference: scripts/evaluation/
eval_prop.py).

`PropertyCalculator` computes the QM properties of up to num_confs
conformers of a molecule through psi4 (by psikit), the conformers chosen
by a RandomState(seed) shuffle as in the JAX package; `ensemble_statistics`
and `compare_ensembles` reduce them to the reference's statistics in eV
(average and lowest energy, mean/min/max HOMO-LUMO gap) and their
|generated - reference| differences. psikit, psi4 and RDKit are optional,
imported when a calculator is made or used: the calculator raises
ImportError naming psikit/psi4 where they are missing. The statistics are
plain numpy.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from agdiff_torch.chem.mol import Molecule

HARTREE_TO_EV = 27.211386245988


class PropertyCalculator:
    """Per-conformer QM properties through psikit/psi4 (reference:
    eval_prop.py:17-56)."""

    def __init__(self, threads: int = 8, memory: int = 16, seed: int = 2021):
        try:
            from psikit import Psikit
        except ImportError as err:
            raise ImportError(
                "psikit and psi4 are required for property evaluation "
                "(pip install psikit, conda install psi4); COV/MAT "
                "evaluation does not need them") from err
        self.pk = Psikit(threads=threads, memory=memory)
        self.seed = seed

    def __call__(self, mol: Molecule, conformers: np.ndarray,
                 num_confs: int = 50) -> Dict[str, List[float]]:
        """energy, homo, lumo (Hartree) and dipole of each conformer that
        psi4 converges on, with its index in `conformers` (conf_idx)."""
        from agdiff_torch.chem import rdkit_bridge

        confs = np.asarray(conformers).reshape(-1, mol.num_nodes, 3)
        idx = np.arange(confs.shape[0])
        np.random.RandomState(self.seed).shuffle(idx)
        out = {"conf_idx": [], "energy": [], "homo": [], "lumo": [],
               "dipole": []}
        for k in idx[:num_confs]:
            self.pk.mol = rdkit_bridge.molecule_to_rdmol(mol, confs[k])
            try:
                energy = float(self.pk.energy())
                homo, lumo = float(self.pk.HOMO), float(self.pk.LUMO)
                dipole = float(self.pk.dipolemoment[-1])
            except Exception:  # psi4 raises several kinds when a
                continue       # conformer does not converge: skip it
            out["energy"].append(energy)
            out["homo"].append(homo)
            out["lumo"].append(lumo)
            out["dipole"].append(dipole)
            out["conf_idx"].append(int(k))
        return out


def ensemble_statistics(props: Dict[str, List[float]]) -> Dict[str, float]:
    """The reference's get_ensemble_energy statistics, in eV."""
    energy = np.array(props["energy"]) * HARTREE_TO_EV
    # the reference takes |homo - lumo| (eval_prop.py:81)
    gap = np.abs(np.array(props["lumo"]) - np.array(props["homo"])) \
        * HARTREE_TO_EV
    return {"avg_energy": float(energy.mean()),
            "low_energy": float(energy.min()),
            "avg_gap": float(gap.mean()), "min_gap": float(gap.min()),
            "max_gap": float(gap.max())}


def compare_ensembles(gen_props, ref_props) -> Dict[str, float]:
    """|gen - ref| of each ensemble statistic (the per-molecule term of
    the reference's MAE report)."""
    g = ensemble_statistics(gen_props)
    r = ensemble_statistics(ref_props)
    return {k: abs(g[k] - r[k]) for k in g}
