"""Training CLI (port of agdiff_tpu/cli/train.py:19-121; reference:
scripts/train.py).

Usage:
  python -m agdiff_torch.cli.train configs/qm9_default.yml [--logdir logs]
  python -m agdiff_torch.cli.train <previous_log_dir> [--resume_iter N]
  python -m agdiff_torch.cli.train configs/synthetic_qm9.yml --synthetic 2048

A log DIRECTORY in place of the config resumes that run (its config.yml
inside it), as in the reference (train.py:39-42). The run is on the CUDA
card unless --device says otherwise. --deterministic asks PyTorch for its
deterministic algorithms (the scatters of the backward then repeat bit for
bit on a card). A config of model.dtype bfloat16 (configs/qm9_fast.yml)
trains at bf16 compute. Refused: --num_devices (data parallelism,
ROADMAP.md queue 1 item 7) and a log dir of the JAX package (item 4c).
"""

from __future__ import annotations

import argparse
import os
import shutil

DP_REFUSAL = ("--num_devices: data-parallel training is not ported "
              "(ROADMAP.md queue 1 item 7, torch.distributed DDP); the port "
              "trains on one device")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="config YAML, or a log dir to resume")
    ap.add_argument("--resume_iter", type=int, default=None)
    ap.add_argument("--logdir", default="./logs")
    ap.add_argument("--tag", default="")
    ap.add_argument("--max_iters", type=int, default=None)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="train on N synthetic molecules (no dataset needed)")
    ap.add_argument("--synthetic_rigid", action="store_true",
                    help="deterministic tetrahedral geometry")
    ap.add_argument("--synthetic_heavy", type=int, default=None,
                    help="max heavy atoms of the synthetic molecules "
                         "(default QM9-like 4-9; 20 ~= Drugs-size)")
    ap.add_argument("--synthetic_confs", type=int, default=1,
                    help="conformers per synthetic molecule, as separate "
                         "datapoints")
    ap.add_argument("--synthetic_chem", default="tree",
                    choices=["tree", "rich"])
    ap.add_argument("--num_devices", type=int, default=0,
                    help="data-parallel devices (not ported: > 0 raises)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    args = ap.parse_args(argv)
    if args.num_devices:
        raise NotImplementedError(DP_REFUSAL)

    import torch

    from agdiff_torch.config import load_config
    from agdiff_torch.data.dataset import ConformationDataset
    from agdiff_torch.train.checkpoint import (
        ORBAX_REFUSAL,
        is_jax_checkpoint,
        latest_checkpoint,
    )
    from agdiff_torch.train.trainer import Trainer
    from agdiff_torch.utils.logging import get_logger, get_new_log_dir
    from agdiff_torch.utils.misc import seed_all

    resume = os.path.isdir(args.config)
    if resume:
        path, _ = latest_checkpoint(args.config, args.resume_iter)
        if is_jax_checkpoint(path):
            raise NotImplementedError(ORBAX_REFUSAL.format(path=path))
        log_dir = args.config
        config_path = os.path.join(log_dir, "config.yml")
        config = load_config(config_path)
    else:
        config_path = args.config
        config = load_config(config_path)
        name = os.path.splitext(os.path.basename(config_path))[0]
        log_dir = get_new_log_dir(args.logdir, prefix=name, tag=args.tag)
        shutil.copyfile(config_path, os.path.join(log_dir, "config.yml"))
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    seed_all(config.train.seed)
    logger = get_logger("train", log_dir)
    logger.info("config: %s | log_dir: %s", config_path, log_dir)

    if args.synthetic:
        from agdiff_torch.data.synthetic import (
            expand_conformers,
            heavy_range,
            synthetic_dataset,
        )

        kw = {}
        if args.synthetic_heavy is not None:
            lo, hi = heavy_range(args.synthetic_heavy)
            kw = dict(min_heavy=lo, max_heavy=hi)
        mols = synthetic_dataset(args.synthetic, seed=config.train.seed,
                                 rigid=args.synthetic_rigid,
                                 chem=args.synthetic_chem, **kw)
        split = max(1, int(len(mols) * 0.9))
        tr_mols, va_mols = mols[:split], mols[split:]
        if args.synthetic_confs > 1:
            # per-conformer datapoints, expanded after the molecule-level
            # split so no graph is in both sets
            tr_mols = expand_conformers(tr_mols, args.synthetic_confs,
                                        seed=config.train.seed + 1)
            va_mols = expand_conformers(va_mols, args.synthetic_confs,
                                        seed=config.train.seed + 2)
        train_set = ConformationDataset(tr_mols)
        val_set = ConformationDataset(va_mols)
    else:
        train_set = ConformationDataset(config.dataset.train)
        val_set = (ConformationDataset(config.dataset.val)
                   if config.dataset.val else None)
    logger.info("train: %d molecules | val: %d", len(train_set),
                len(val_set) if val_set else 0)

    trainer = Trainer(config, train_set, val_set, log_dir, logger,
                      device=args.device)
    if resume:
        trainer.resume(log_dir, args.resume_iter)
    trainer.train(max_iters=args.max_iters)
    return trainer


if __name__ == "__main__":
    main()
