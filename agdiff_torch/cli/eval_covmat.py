"""COV/MAT evaluation CLI (port of agdiff_tpu/cli/eval_covmat.py;
reference: scripts/evaluation/eval_covmat.py).

Usage:
  python -m agdiff_torch.cli.eval_covmat <samples_all.npz> [--ratio 2]
      [--start_idx 0] [--num_workers 8] [--max_maps 10000]

Reads a samples file of either package (eval/generate.py load_samples)
and writes <samples>_covmat.csv (the summary table; pandas where present,
else the csv module) and <samples>_covmat.npz (CoverageR, MatchingR,
CoverageP, MatchingP, thresholds). The RMSDs run on the host (numpy and
native/rmsd.cpp), never on a CUDA device. --use_ff / --useFF relaxes
each generated conformer with RDKit's MMFF94 first (chem/rdkit_bridge.py),
and raises ImportError naming RDKit where it is not installed.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("samples", help="samples_all.npz from cli.generate")
    ap.add_argument("--use_ff", "--useFF", action="store_true")
    ap.add_argument("--ratio", type=int, default=2)
    ap.add_argument("--start_idx", type=int, default=0)
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--max_maps", type=int, default=10000)
    args = ap.parse_args(argv)

    import numpy as np

    from agdiff_torch.cli._common import get_logger
    from agdiff_torch.eval.covmat import CovMatEvaluator, \
        print_covmat_results
    from agdiff_torch.eval.generate import load_samples

    logger = get_logger("eval_covmat")
    data_list = load_samples(args.samples)
    logger.info("loaded %d packed molecules", len(data_list))
    evaluator = CovMatEvaluator(
        num_workers=args.num_workers, use_force_field=args.use_ff,
        ratio=args.ratio, max_maps=args.max_maps, print_fn=logger.info)
    results = evaluator(data_list, start_idx=args.start_idx)
    df = print_covmat_results(results, print_fn=logger.info)

    base = os.path.splitext(args.samples)[0]
    csv_path = base + "_covmat.csv"
    if isinstance(df, list):   # no pandas
        import csv

        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(df[0].keys()))
            w.writeheader()
            w.writerows(df)
    else:
        df.to_csv(csv_path)
    np.savez(base + "_covmat.npz", CoverageR=results.CoverageR,
             MatchingR=results.MatchingR, CoverageP=results.CoverageP,
             MatchingP=results.MatchingP, thresholds=results.thresholds)
    logger.info("saved: %s", csv_path)
    return results


if __name__ == "__main__":
    main()
