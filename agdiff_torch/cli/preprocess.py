"""Dataset preprocessing CLI (port of agdiff_tpu/cli/preprocess.py): the
raw GEOM dump or a reference .pkl -> the .npz molecule format both
packages read (chem/mol.py save_molecules).

Usage:
  # the raw GEOM dump (needs RDKit):
  python -m agdiff_torch.cli.preprocess geom --base_path data/GEOM/rdkit_folder \\
      --dataset qm9 --out_dir data/GEOM/QM9
  # a reference .pkl dataset (RDKit only if its Data hold RDKit objects):
  python -m agdiff_torch.cli.preprocess convert train_data_40k.pkl out.npz

`geom` writes train_data_<k>k.npz, val_data_5k.npz and test_data_5k.npz
(data/geom.py preprocess_geom_fixed_num_conf) and test_data_large_conf.npz
(get_test_set_with_large_num_conf, the training and validation SMILES
blocked).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("geom", help="preprocess raw GEOM (needs RDKit)")
    g.add_argument("--base_path", required=True)
    g.add_argument("--dataset", choices=["qm9", "drugs"], required=True)
    g.add_argument("--out_dir", required=True)
    g.add_argument("--conf_per_mol", type=int, default=5)
    g.add_argument("--tot_mol_size", type=int, default=50000)
    g.add_argument("--train_size", type=float, default=0.8)
    g.add_argument("--seed", type=int, default=2021)
    g.add_argument("--test_min_conf", type=int, default=50)
    g.add_argument("--test_max_conf", type=int, default=500)
    g.add_argument("--test_mol_size", type=int, default=1000)

    c = sub.add_parser("convert", help="reference .pkl -> .npz")
    c.add_argument("src")
    c.add_argument("dst")

    args = ap.parse_args(argv)

    from agdiff_torch.chem.mol import save_molecules
    from agdiff_torch.utils.logging import get_logger

    logger = get_logger("preprocess")

    if args.cmd == "convert":
        from agdiff_torch.data.geom import load_reference_pickle

        mols = load_reference_pickle(args.src)
        save_molecules(args.dst, mols)
        logger.info("converted %d molecules: %s -> %s", len(mols), args.src,
                    args.dst)
        return

    from agdiff_torch.chem.rdkit_bridge import require_rdkit
    from agdiff_torch.data.geom import (
        get_test_set_with_large_num_conf,
        preprocess_geom_fixed_num_conf,
    )

    require_rdkit()
    os.makedirs(args.out_dir, exist_ok=True)
    train, val, test, _ = preprocess_geom_fixed_num_conf(
        args.base_path, args.dataset, conf_per_mol=args.conf_per_mol,
        train_size=args.train_size, tot_mol_size=args.tot_mol_size,
        seed=args.seed)
    k = args.tot_mol_size // 1000
    save_molecules(
        os.path.join(args.out_dir, f"train_data_{int(k * 0.8)}k.npz"), train)
    save_molecules(os.path.join(args.out_dir, "val_data_5k.npz"), val)
    save_molecules(os.path.join(args.out_dir, "test_data_5k.npz"), test)
    logger.info("splits: train %d / val %d / test %d", len(train), len(val),
                len(test))

    block = sorted({m.smiles for m in train + val if m.smiles})
    packed = get_test_set_with_large_num_conf(
        args.base_path, args.dataset, block=block,
        tot_mol_size=args.test_mol_size, min_conf=args.test_min_conf,
        max_conf=args.test_max_conf, seed=args.seed)
    save_molecules(
        os.path.join(args.out_dir, "test_data_large_conf.npz"), packed)
    logger.info("packed test set: %d molecules", len(packed))


if __name__ == "__main__":
    main()
