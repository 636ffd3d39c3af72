"""Generation CLI (port of agdiff_tpu/cli/generate.py; reference:
scripts/test.py).

Usage:
  python -m agdiff_torch.cli.generate model.pt --test_set test.npz \
      --fast --engine mono [--out_dir samples] [--start_idx 0 --end_idx 200] \
      [--num_confs 2x] [--n_steps 5000] [--device cpu]

The checkpoint is a reference .pt; its model config travels in it
(reference: test.py:111), and the sampling hyperparameters are flags
(test.py:40-75 defaults). Samples go to <out_dir>/samples_<i>.npz, one per
molecule as it is done (a rerun skips those that exist unless
--no_resume), and samples_all.npz at the end, in the JAX package's format.
--fast samples with the folded engines (the runner's choice, or
--engine); without it, with the dense module. The run is on the CUDA card
unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import os

from agdiff_torch.models.fast_forward import ENGINES as TRIU_ENGINES
from agdiff_torch.models.tight_forward import ENGINES as TIGHT_ENGINES

# 'xla' is the JAX name of the plain folded forward (engine None); the
# runner refuses 'pallas' (eval/generate.py)
ENGINE_CHOICES = (["xla"] + [e for e in TRIU_ENGINES
                             if e not in (None, "pallas")]
                  + list(TIGHT_ENGINES) + ["mono"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", help="reference .pt checkpoint")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--test_set", required=True,
                    help=".npz test set (chem/mol.save_molecules format)")
    ap.add_argument("--start_idx", type=int, default=0)
    ap.add_argument("--end_idx", type=int, default=200)
    ap.add_argument("--num_confs", default="2x")
    ap.add_argument("--n_steps", type=int, default=5000)
    ap.add_argument("--step_lr", type=float, default=1e-6)
    ap.add_argument("--w_global", type=float, default=1.0)
    ap.add_argument("--global_start_sigma", type=float, default=0.5)
    ap.add_argument("--clip", type=float, default=1000.0)
    ap.add_argument("--clip_local", type=float, default=None)
    ap.add_argument("--clip_pos", type=float, default=None)
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--chunk_size", type=int, default=64)
    ap.add_argument("--no_resume", action="store_true")
    ap.add_argument("--engine", default=None, choices=ENGINE_CHOICES,
                    help="fast-path engine (with --fast): xla = the plain "
                         "f32 folded forward; tight* = pair lists sized to "
                         "the molecule; pks/pksg/pksf = K1; pk = K2; mono "
                         "= the whole forward as one K6 launch")
    ap.add_argument("--fast", action="store_true",
                    help="the folded engines instead of the dense module")
    ap.add_argument("--dtype", default=None,
                    choices=[None, "float32", "bfloat16"],
                    help="override the checkpoint config's compute dtype")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from agdiff_torch.cli._common import get_logger, load_inference_bundle
    from agdiff_torch.data.dataset import PackedConformationDataset
    from agdiff_torch.eval.generate import GenerationRunner
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import SamplerConfig

    out_dir = args.out_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(args.ckpt))) or ".",
        "samples_0")
    logger = get_logger("generate", out_dir)
    logger.info("checkpoint: %s -> out: %s", args.ckpt, out_dir)
    config, model = load_inference_bundle(args.ckpt, args.dtype, logger)
    dataset = PackedConformationDataset(args.test_set).molecules
    scfg = SamplerConfig(
        n_steps=args.n_steps, step_lr=args.step_lr, w_global=args.w_global,
        global_start_sigma=args.global_start_sigma, clip=args.clip,
        clip_local=args.clip_local, clip_pos=args.clip_pos)
    runner = GenerationRunner(
        model, config.model, make_diffusion(config.model), scfg,
        buckets=config.buckets, chunk_size=args.chunk_size,
        device=args.device,
        engine=None if args.engine in (None, "xla") else args.engine,
        use_fast=args.fast, logger=logger)
    runner.run(dataset, out_dir, seed=args.seed, num_confs=args.num_confs,
               start_idx=args.start_idx, end_idx=args.end_idx,
               resume=not args.no_resume)
    logger.info("done: %s/samples_all.npz", out_dir)


if __name__ == "__main__":
    main()
