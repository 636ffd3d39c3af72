"""COV/MAT: coverage and matching over the best-RMSD confusion matrices
(port of agdiff_tpu/eval/covmat.py; reference:
src/agdiff/utils/evaluation/covmat.py). Host numpy and C++ only: nothing
here touches a CUDA device.

* Per molecule, the (num_ref, num_gen) symmetry-aware heavy-atom best-RMSD
  matrix (chem/rmsd.py: native/rmsd.cpp with use_native, the default,
  else numpy; the native path raises rather than falling back).
* Filter: pos_gen and pos_ref present; disconnected SMILES ("." in it)
  dropped (covmat.py:104); at least ratio x num_ref generated conformers,
  truncated to exactly that many (covmat.py:114-117).
* COV-R(t): the share of references whose least RMSD over the generated
  ones is <= t; COV-P(t): the share of generated ones whose least RMSD
  over the references is <= t; MAT-R and MAT-P the means of those
  minima; t = 0.05, 0.10, ..., 3.00.
* Molecules in parallel over a `spawn` process pool (num_workers, 8 by
  default).
* use_force_field relaxes each generated conformer with MMFF94 before it
  is scored (the reference's useFF, MMFFOptimizeMolecule, through
  chem/rdkit_bridge.py): it needs RDKit, and the evaluator raises
  ImportError naming it when constructed where RDKit is missing.
"""

from __future__ import annotations

import multiprocessing as mp
from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import numpy as np

from agdiff_torch.chem.mol import Molecule
from agdiff_torch.chem.rmsd import rmsd_confusion_matrix

THRESHOLDS = np.arange(0.05, 3.05, 0.05)


def _confusion_for(packed: Molecule, max_maps: int, use_native: bool,
                   use_ff: bool) -> np.ndarray:
    n = packed.num_nodes
    gens = np.asarray(packed.meta["pos_gen"]).reshape(-1, n, 3)
    if use_ff:
        from agdiff_torch.chem.rdkit_bridge import mmff_optimize_positions

        gens = np.stack([mmff_optimize_positions(packed, g) for g in gens])
    return rmsd_confusion_matrix(
        packed, packed.pos_ref.reshape(-1, n, 3), gens,
        max_maps=max_maps, use_native=use_native)


@dataclass
class CovMatResults:
    CoverageR: np.ndarray   # (num_mols, num_thresholds)
    MatchingR: np.ndarray   # (num_mols,)
    CoverageP: np.ndarray
    MatchingP: np.ndarray
    thresholds: np.ndarray


class CovMatEvaluator:
    def __init__(self, num_workers: int = 8, use_force_field: bool = False,
                 thresholds: Optional[np.ndarray] = None, ratio: int = 2,
                 filter_disconnected: bool = True, max_maps: int = 10000,
                 print_fn=print, use_native: bool = True):
        if use_force_field:
            from agdiff_torch.chem import rdkit_bridge

            rdkit_bridge.require_rdkit()
        self.num_workers = num_workers
        self.use_force_field = use_force_field
        self.thresholds = (THRESHOLDS if thresholds is None
                           else np.asarray(thresholds).flatten())
        self.ratio = ratio
        self.filter_disconnected = filter_disconnected
        self.max_maps = max_maps
        self.print_fn = print_fn
        self.use_native = use_native

    @property
    def path(self) -> str:
        """The confusion matrices' path: "native" or "numpy"."""
        return "native" if self.use_native else "numpy"

    def filter(self, packed_list: List[Molecule]) -> List[Molecule]:
        out = []
        for mol in packed_list:
            if mol.pos_ref is None or "pos_gen" not in mol.meta:
                continue
            if self.filter_disconnected and mol.smiles and "." in mol.smiles:
                continue
            n = mol.num_nodes
            num_ref = mol.pos_ref.reshape(-1, n, 3).shape[0]
            gens = np.asarray(mol.meta["pos_gen"]).reshape(-1, n, 3)
            need = num_ref * self.ratio
            if gens.shape[0] < need:
                continue
            mol.meta["pos_gen"] = gens[:need]
            out.append(mol)
        return out

    def confusion_matrices(self, mols: List[Molecule]) -> List[np.ndarray]:
        """Each molecule's matrix, over the pool when it has workers."""
        func = partial(_confusion_for, max_maps=self.max_maps,
                       use_native=self.use_native,
                       use_ff=self.use_force_field)
        if self.num_workers > 1 and len(mols) > 1:
            if self.use_native:   # built once here, loaded by each worker
                from agdiff_torch.chem import native_rmsd

                native_rmsd.get_lib()
            with mp.get_context("spawn").Pool(self.num_workers) as pool:
                return list(pool.map(func, mols))
        return [func(m) for m in mols]

    def __call__(self, packed_list: List[Molecule],
                 start_idx: int = 0) -> CovMatResults:
        filtered = self.filter(packed_list)[start_idx:]
        self.print_fn(f"Filtered: {len(filtered)} / {len(packed_list)} "
                      f"(RMSD: {self.path})")
        covr, matr, covp, matp = [], [], [], []
        for cm in self.confusion_matrices(filtered):
            ref_min = cm.min(axis=-1)   # (num_ref,)
            gen_min = cm.min(axis=0)    # (num_gen,)
            covr.append((ref_min[:, None] <= self.thresholds[None]).mean(0))
            covp.append((gen_min[:, None] <= self.thresholds[None]).mean(0))
            matr.append(ref_min.mean())
            matp.append(gen_min.mean())
        empty = np.zeros((0, len(self.thresholds)))
        return CovMatResults(
            CoverageR=np.vstack(covr) if covr else empty,
            MatchingR=np.array(matr),
            CoverageP=np.vstack(covp) if covp else empty,
            MatchingP=np.array(matp), thresholds=self.thresholds)


def print_covmat_results(results: CovMatResults, print_fn=print):
    """The summary table (reference: covmat.py:43-72): returns its rows
    as a pandas DataFrame where pandas is present, else a list of
    dicts."""
    rows = []
    for k, t in enumerate(results.thresholds):
        row = {"threshold": float(t)}
        for name, cov in (("COV-R", results.CoverageR),
                          ("COV-P", results.CoverageP)):
            row[f"{name}_mean"] = float(np.mean(cov[:, k]))
            row[f"{name}_median"] = float(np.median(cov[:, k]))
            row[f"{name}_std"] = float(np.std(cov[:, k]))
        rows.append(row)
    for name, mat in (("MAT-R", results.MatchingR),
                      ("MAT-P", results.MatchingP)):
        print_fn("%s_mean: %.4f | %s_median: %.4f | %s_std %.4f"
                 % (name, np.mean(mat), name, np.median(mat), name,
                    np.std(mat)))
    try:
        import pandas as pd
    except ImportError:
        return rows
    df = pd.DataFrame(rows).set_index("threshold")
    print_fn("\n" + str(df))
    return df
