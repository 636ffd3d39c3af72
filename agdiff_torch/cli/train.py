"""Training CLI (port of agdiff_tpu/cli/train.py:19-121; reference:
scripts/train.py).

Usage:
  python -m agdiff_torch.cli.train configs/qm9_default.yml [--logdir logs]
  python -m agdiff_torch.cli.train <previous_log_dir> [--resume_iter N]
  python -m agdiff_torch.cli.train configs/synthetic_qm9.yml --synthetic 2048

  python -m agdiff_torch.cli.train configs/qm9_fast.yml --num_devices 2

A log DIRECTORY in place of the config resumes that run (its config.yml
inside it), as in the reference (train.py:39-42). The run is on the CUDA
card unless --device says otherwise. --deterministic asks PyTorch for its
deterministic algorithms (the scatters of the backward then repeat bit for
bit on a card). A config of model.dtype bfloat16 (configs/qm9_fast.yml)
trains at bf16 compute. --num_devices N trains data-parallel over N ranks
(parallel/mesh.py launch: one card a rank over NCCL, or N ranks over gloo
with --device cpu; more ranks than cards raise), each batch's graphs
split over them, the step the global batch's (train/trainer.py).

A log dir of the JAX package resumes once its checkpoint is converted
(convert_jax_checkpoint.py at the repository's root, run where jax is
installed; an unconverted one raises, naming it): the run continues from
the checkpoint's iteration + 1 with the JAX state's parameters, running
statistics, both Adams, EMA shadow and plateau states, and writes the
port's checkpoints (state.pt) into the same log dir from there on. The
JAX package saves no generator or loader state, so those start as a
fresh run's, as the JAX package's own resume starts them.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import List, NamedTuple


class TrainRun(NamedTuple):
    """What a data-parallel run returns from rank 0."""

    log_dir: str
    losses: List[float]


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
                    help="data-parallel over this many ranks (0 = one "
                         "process, no group)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    args = ap.parse_args(argv)
    if args.num_devices:
        from agdiff_torch.parallel.mesh import placement

        placement(args.num_devices, args.device)   # raises without the cards

    from agdiff_torch.train.checkpoint import (
        UNCONVERTED,
        latest_checkpoint,
        unconverted,
    )
    from agdiff_torch.utils.logging import get_new_log_dir

    resume = os.path.isdir(args.config)
    if resume:
        path, _ = latest_checkpoint(args.config, args.resume_iter)
        if unconverted(path):
            raise FileNotFoundError(UNCONVERTED.format(path=path))
        log_dir = args.config
        config_path = os.path.join(log_dir, "config.yml")
    else:
        config_path = args.config
        name = os.path.splitext(os.path.basename(config_path))[0]
        log_dir = get_new_log_dir(args.logdir, prefix=name, tag=args.tag)
        shutil.copyfile(config_path, os.path.join(log_dir, "config.yml"))
    if not args.num_devices:
        return train(None, args, log_dir, config_path, resume)
    from agdiff_torch.parallel import launch

    return launch(_train_rank, args.num_devices, args, log_dir, config_path,
                  resume, device=args.device)


def _train_rank(group, args, log_dir, config_path, resume) -> TrainRun:
    trainer = train(group, args, log_dir, config_path, resume)
    return TrainRun(trainer.log_dir, trainer.losses)


def train(group, args, log_dir: str, config_path: str, resume: bool):
    """The run of main's arguments in this process: alone (group None)
    or as one rank of a data-parallel group; returns the Trainer."""
    import torch

    from agdiff_torch.config import load_config
    from agdiff_torch.data.dataset import ConformationDataset
    from agdiff_torch.train.trainer import Trainer
    from agdiff_torch.utils.logging import get_logger
    from agdiff_torch.utils.misc import seed_all

    config = load_config(config_path)
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    seed_all(config.train.seed)
    writer = group is None or group.is_writer
    logger = get_logger("train", log_dir) if writer else None
    if logger:
        logger.info("config: %s | log_dir: %s", config_path, log_dir)
        if group is not None:
            logger.info("data-parallel over %d ranks (%s, %s)",
                        group.world_size, group.backend, group.device)

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
    if logger:
        logger.info("train: %d molecules | val: %d", len(train_set),
                    len(val_set) if val_set else 0)

    trainer = Trainer(config, train_set, val_set, log_dir, logger,
                      device=args.device, group=group)
    if resume:
        trainer.resume(log_dir, args.resume_iter)
    trainer.train(max_iters=args.max_iters)
    return trainer


if __name__ == "__main__":
    main()
