"""COV/MAT in one process with per-molecule outputs (port of
agdiff_tpu/eval/covmat_linear.py; reference:
src/agdiff/utils/evaluation/covmat_rmsd_linear.py): besides the
evaluator's arrays, each molecule's SMILES, least RMSD, mean of its
references' top_n best RMSDs and confusion matrix; `max_num_gen` caps the
generated conformers after the ratio cut (covmat_rmsd_linear.py:110-115).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from agdiff_torch.chem.mol import Molecule
from agdiff_torch.eval.covmat import CovMatEvaluator, CovMatResults


@dataclass
class LinearCovMatResults(CovMatResults):
    smiles: List[Optional[str]] = None
    min_rmsd: np.ndarray = None          # (num_mols,)
    avg_best_n_rmsd: np.ndarray = None   # (num_mols,)
    confusion_matrices: List[np.ndarray] = None


class LinearCovMatEvaluator(CovMatEvaluator):
    """The evaluator in one process, with per-molecule outputs."""

    def __init__(self, *args, top_n: int = 5, max_num_gen: int = 5,
                 **kwargs):
        kwargs["num_workers"] = 1
        super().__init__(*args, **kwargs)
        self.top_n = top_n
        self.max_num_gen = max_num_gen

    def filter(self, packed_list: List[Molecule]) -> List[Molecule]:
        out = super().filter(packed_list)
        for mol in out:
            mol.meta["pos_gen"] = mol.meta["pos_gen"][:self.max_num_gen]
        return out

    def __call__(self, packed_list: List[Molecule],
                 start_idx: int = 0) -> LinearCovMatResults:
        filtered = self.filter(packed_list)[start_idx:]
        self.print_fn(f"Filtered: {len(filtered)} / {len(packed_list)} "
                      f"(RMSD: {self.path})")
        covr, matr, covp, matp = [], [], [], []
        smiles, min_rmsds, avg_best = [], [], []
        mats = self.confusion_matrices(filtered)
        for mol, cm in zip(filtered, mats):
            ref_sorted = np.sort(cm, axis=-1)
            ref_min = ref_sorted[:, 0]
            gen_min = np.sort(cm, axis=0)[0, :]
            covr.append((ref_min[:, None] <= self.thresholds[None]).mean(0))
            covp.append((gen_min[:, None] <= self.thresholds[None]).mean(0))
            matr.append(ref_min.mean())
            matp.append(gen_min.mean())
            smiles.append(mol.smiles)
            min_rmsds.append(cm.min())
            avg_best.append(ref_sorted[:, :self.top_n].mean())
        empty = np.zeros((0, len(self.thresholds)))
        return LinearCovMatResults(
            CoverageR=np.vstack(covr) if covr else empty,
            MatchingR=np.array(matr),
            CoverageP=np.vstack(covp) if covp else empty,
            MatchingP=np.array(matp), thresholds=self.thresholds,
            smiles=smiles, min_rmsd=np.array(min_rmsds),
            avg_best_n_rmsd=np.array(avg_best), confusion_matrices=mats)
