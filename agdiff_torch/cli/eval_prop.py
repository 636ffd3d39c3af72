"""Ensemble-property evaluation CLI (port of agdiff_tpu/cli/eval_prop.py;
reference: scripts/evaluation/eval_prop.py): psi4's energy, HOMO, LUMO and
dipole of generated and reference conformer ensembles, reported as |gen -
ref| of each statistic in eV, per molecule and as the mean over molecules.

Usage:
  python -m agdiff_torch.cli.eval_prop <samples_all.npz> [--num_confs 50]
      [--threads 8] [--memory 16] [--seed 2021]

Reads a samples file of either package (eval/generate.py load_samples).
Needs psikit, psi4 and RDKit (eval/properties.py); runs on the host.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("samples", help="samples_all.npz from cli.generate")
    ap.add_argument("--num_confs", type=int, default=50)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--memory", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2021)
    args = ap.parse_args(argv)

    import numpy as np

    from agdiff_torch.eval.generate import load_samples
    from agdiff_torch.eval.properties import (
        PropertyCalculator,
        compare_ensembles,
    )
    from agdiff_torch.utils.logging import get_logger

    logger = get_logger("eval_prop")
    data_list = load_samples(args.samples)
    calc = PropertyCalculator(threads=args.threads, memory=args.memory,
                              seed=args.seed)
    diffs = []
    for k, mol in enumerate(data_list):
        if mol.pos_ref is None or "pos_gen" not in mol.meta:
            continue
        n = mol.num_nodes
        gen_props = calc(mol, mol.meta["pos_gen"], num_confs=args.num_confs)
        ref_props = calc(mol, mol.pos_ref.reshape(-1, n, 3),
                         num_confs=args.num_confs)
        if not gen_props["energy"] or not ref_props["energy"]:
            logger.warning("molecule %d: no converged conformers", k)
            continue
        d = compare_ensembles(gen_props, ref_props)
        diffs.append(d)
        logger.info("molecule %d: %s", k,
                    {kk: round(vv, 4) for kk, vv in d.items()})
    if diffs:
        logger.info("--- MAE over %d molecules (eV) ---", len(diffs))
        for kk in diffs[0]:
            logger.info("%s: %.4f", kk,
                        float(np.mean([d[kk] for d in diffs])))
    return diffs


if __name__ == "__main__":
    main()
