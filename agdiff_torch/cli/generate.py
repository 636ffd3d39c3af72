"""Generation CLI (port of agdiff_tpu/cli/generate.py; reference:
scripts/test.py).

Usage:
  python -m agdiff_torch.cli.generate (model.pt | <log_dir> [--ckpt_iter N]
      [--ema] | <log_dir>/checkpoints/<N>) (--test_set test.npz |
      --synthetic 8 [--synthetic_heavy 20]) --fast --engine mono \
      [--out_dir samples] [--start_idx 0 --end_idx 200] [--num_confs 2x] \
      [--n_steps 5000] [--ladder strided --sampling_type generalized \
      --eta 0 --solver heun] [--denoise_tail 10] [--device cpu]

The checkpoint is a log dir of cli/train.py (its latest checkpoint, or
--ckpt_iter's), one of its checkpoint directories, a log dir or checkpoint
directory of the JAX package converted by convert_jax_checkpoint.py, or a
reference .pt; the
model config travels in it (reference: test.py:111), and the sampling
hyperparameters are flags (test.py:40-75 defaults). --ema samples with the
EMA shadow's parameters and the raw running statistics. Samples go to <out_dir>/samples_<i>.npz, one per
molecule as it is done (a rerun skips those that exist unless
--no_resume), and samples_all.npz at the end, in the JAX package's format.
--fast samples with the folded engines (the runner's choice, or
--engine); without it, with the dense module at the config's compute
dtype (--dtype overrides it). The run is on the CUDA card,
where each ladder replays CUDA graphs, unless --device says otherwise.
--synthetic takes the molecules from data/synthetic.py with the JAX
CLI's arguments (seed 7, three reference conformers). --packed runs
eval/generate.py's PackedGenerationRunner: each chunk holds samples of
several molecules of a bucket (of one atom count at a tight engine's
bucket) instead of one molecule repeated. --num_devices N runs the
runner data-parallel over N ranks (parallel/mesh.py launch: one card a
rank over NCCL, or gloo ranks with --device cpu; more ranks than cards
raise): each chunk's graphs split over the ranks, the samples those of
one process (eval/generate.py), rank 0 writing the files.
"""

from __future__ import annotations

import argparse
import os

from agdiff_torch.models.fast_forward import ENGINES as TRIU_ENGINES
from agdiff_torch.models.tight_forward import ENGINES as TIGHT_ENGINES

# 'xla' is the JAX name of the plain folded forward (engine None); the
# runner refuses 'pallas' (eval/generate.py). A superset of the JAX CLI's
# list (agdiff_tpu/cli/generate.py:80-87).
ENGINE_CHOICES = (["xla"] + [e for e in TRIU_ENGINES
                             if e not in (None, "pallas")]
                  + list(TIGHT_ENGINES) + ["mono"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", help="log dir of cli/train.py, one of its "
                                 "checkpoint directories, or a reference "
                                 ".pt checkpoint")
    ap.add_argument("--ckpt_iter", type=int, default=None,
                    help="the log dir's checkpoint of this iteration "
                         "(default: the latest)")
    ap.add_argument("--ema", action="store_true",
                    help="sample with the EMA shadow weights (a run "
                         "trained with train.ema_decay > 0)")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--test_set", default=None,
                    help=".npz test set (chem/mol.save_molecules format) "
                         "or the reference's .pkl (data/geom.py); required "
                         "without --synthetic")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate for this many synthetic molecules "
                         "(data/synthetic.py, seed 7, 3 reference "
                         "conformers) instead of a test set")
    ap.add_argument("--synthetic_heavy", type=int, default=None,
                    help="max heavy atoms of the synthetic molecules "
                         "(default QM9-like 4-9; 20 ~= Drugs-size)")
    ap.add_argument("--synthetic_rigid", action="store_true",
                    help="deterministic tetrahedral geometry")
    ap.add_argument("--synthetic_multiref", action="store_true",
                    help="reference conformers are distinct torsion "
                         "conformers instead of jitters of one structure")
    ap.add_argument("--synthetic_chem", default="tree",
                    choices=["tree", "rich"])
    ap.add_argument("--start_idx", type=int, default=0)
    ap.add_argument("--end_idx", type=int, default=200)
    ap.add_argument("--num_confs", default="2x")
    ap.add_argument("--n_steps", type=int, default=5000)
    ap.add_argument("--ladder", default="suffix",
                    choices=["suffix", "strided"],
                    help="suffix = the last n_steps noise levels (the "
                         "reference); strided = n_steps levels over the "
                         "whole schedule")
    ap.add_argument("--step_lr", type=float, default=1e-6)
    ap.add_argument("--w_global", type=float, default=1.0)
    ap.add_argument("--global_start_sigma", type=float, default=0.5)
    ap.add_argument("--clip", type=float, default=1000.0)
    ap.add_argument("--clip_local", type=float, default=None)
    ap.add_argument("--clip_pos", type=float, default=None)
    ap.add_argument("--denoise_tail", type=int, default=0,
                    help="extra noise-free steps at the last noise level")
    ap.add_argument("--sampling_type", default="ld",
                    choices=["ld", "generalized"],
                    help="'ld' = the reference's annealed Langevin; "
                         "'generalized' = DDIM (with --ladder strided for "
                         "few-step sampling)")
    ap.add_argument("--eta", type=float, default=1.0,
                    help="'generalized' noise (0 = deterministic DDIM)")
    ap.add_argument("--solver", default="euler", choices=["euler", "heun"],
                    help="'generalized' solver; 'heun' is second order "
                         "(--eta 0, two forwards a step)")
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--chunk_size", type=int, default=64)
    ap.add_argument("--no_resume", action="store_true")
    ap.add_argument("--engine", default=None, choices=ENGINE_CHOICES,
                    help="fast-path engine (with --fast): xla = the plain "
                         "f32 folded forward; tight* = pair lists sized to "
                         "the molecule; pks/pksg/pksf = K1; pk = K2; mono "
                         "= the whole forward as one K6 launch; approx = "
                         "polynomial transcendentals; slim/slim8 = bf16/fp8 "
                         "storage of the largest per-edge buffers, stack = "
                         "the stacked filters (no hand kernel); -e16 = the "
                         "edge encoder at bf16")
    ap.add_argument("--fast", action="store_true",
                    help="the folded engines instead of the dense module")
    ap.add_argument("--packed", action="store_true",
                    help="pack samples of several molecules of a bucket "
                         "into each chunk (PackedGenerationRunner)")
    ap.add_argument("--dtype", default=None,
                    choices=[None, "float32", "bfloat16"],
                    help="override the checkpoint config's compute "
                         "dtype: the fast engines' and, without --fast, "
                         "the dense module's (bfloat16 samples the bf16 "
                         "module, as the JAX CLI does)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--num_devices", type=int, default=0,
                    help="data-parallel over this many ranks (0 = one "
                         "process, no group)")
    args = ap.parse_args(argv)
    if not args.synthetic and not args.test_set:
        ap.error("--test_set is required without --synthetic")
    if not args.num_devices:
        return generate(None, args)
    from agdiff_torch.parallel import launch

    return launch(generate, args.num_devices, args, device=args.device)


def generate(group, args) -> str:
    """The run of main's arguments in this process, alone (group None) or
    as one rank of a data-parallel group; returns the output directory."""
    from agdiff_torch.cli._common import (
        get_logger,
        load_inference_bundle,
        resolve_checkpoint,
    )
    from agdiff_torch.data.dataset import PackedConformationDataset
    from agdiff_torch.eval.generate import (
        GenerationRunner,
        PackedGenerationRunner,
    )
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import SamplerConfig

    ckpt_path, it = resolve_checkpoint(args.ckpt, args.ckpt_iter)
    out_dir = args.out_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(ckpt_path))) or ".",
        f"samples_{it}")
    logger = (get_logger("generate", out_dir)
              if group is None or group.is_writer else None)
    if logger:
        logger.info("checkpoint: %s -> out: %s", ckpt_path, out_dir)
    config, model, _, _ = load_inference_bundle(
        args.ckpt, args.ckpt_iter, args.dtype, logger, use_ema=args.ema)
    if args.synthetic:
        from agdiff_torch.data.synthetic import heavy_range, synthetic_dataset

        kw = {}
        if args.synthetic_heavy is not None:
            lo, hi = heavy_range(args.synthetic_heavy)
            kw = dict(min_heavy=lo, max_heavy=hi)
        dataset = synthetic_dataset(
            args.synthetic, seed=7, num_conformers=3,
            rigid=args.synthetic_rigid, chem=args.synthetic_chem,
            multiref=args.synthetic_multiref, **kw)
    else:
        dataset = PackedConformationDataset(args.test_set).molecules
    scfg = SamplerConfig(
        n_steps=args.n_steps, ladder=args.ladder, step_lr=args.step_lr,
        w_global=args.w_global, global_start_sigma=args.global_start_sigma,
        clip=args.clip, clip_local=args.clip_local, clip_pos=args.clip_pos,
        denoise_tail=args.denoise_tail, sampling_type=args.sampling_type,
        eta=args.eta, solver=args.solver)
    runner_cls = PackedGenerationRunner if args.packed else GenerationRunner
    runner = runner_cls(
        model, config.model, make_diffusion(config.model), scfg,
        buckets=config.buckets, chunk_size=args.chunk_size,
        device=args.device,
        engine=None if args.engine in (None, "xla") else args.engine,
        use_fast=args.fast, logger=logger, group=group)
    runner.run(dataset, out_dir, seed=args.seed, num_confs=args.num_confs,
               start_idx=args.start_idx, end_idx=args.end_idx,
               resume=not args.no_resume)
    if logger:
        logger.info("done: %s/samples_all.npz", out_dir)
    return out_dir


if __name__ == "__main__":
    main()
