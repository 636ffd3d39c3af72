"""SMILES -> conformers CLI (port of agdiff_tpu/cli/smiles_generation.py;
reference: smiles_generation.py).

Usage:
  python -m agdiff_torch.cli.smiles_generation <ckpt_or_logdir> \\
      --smiles "CCO" --out_sdf out.sdf [--num_samples auto] [--fast] \\
      [--engine xla|tight|mono] [--device cpu]

The pipeline (reference smiles_generation.py:253-445): the SMILES with its
hydrogens, embedded by ETKDGv3 (RDKit), -> the Langevin ladder on the
order-3 extended graph -> an SDF of the samples (RDKit). Under
--num_samples auto the reference's count holds: 5 x (1100 // atoms)
(lines 325, 328). Parsing and the SDF need RDKit (chem/rdkit_bridge.py);
`generate_for_molecule`, everything between them, does not: it loads a
checkpoint of cli/train.py (a log dir or checkpoint directory) or a
reference .pt and samples through GenerationRunner, with --fast on the
runner's engine (on a bf16 checkpoint 'pksf', the hand kernel K1, at
buckets below 40, 'tight-pksf' above). A checkpoint of the JAX package
loads once convert_jax_checkpoint.py has converted it
(train/checkpoint.py). The run is on the CUDA card unless --device says
otherwise.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", help="log dir, checkpoint directory or "
                                 "reference .pt")
    ap.add_argument("--smiles", required=True)
    ap.add_argument("--out_sdf", required=True)
    ap.add_argument("--num_samples", default="auto",
                    help="'auto' = 5 * (1100 // num_nodes), or an integer")
    ap.add_argument("--n_steps", type=int, default=5000)
    ap.add_argument("--step_lr", type=float, default=1e-6)
    ap.add_argument("--w_global", type=float, default=1.0)
    ap.add_argument("--global_start_sigma", type=float, default=0.5)
    ap.add_argument("--clip", type=float, default=1000.0)
    ap.add_argument("--clip_local", type=float, default=None)
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--chunk_size", type=int, default=64)
    ap.add_argument("--fast", action="store_true",
                    help="the folded engines (the runner's choice by bucket "
                         "and dtype) instead of the dense module")
    ap.add_argument("--engine", default=None,
                    choices=["xla", "tight", "mono"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def sample_count(num_samples, num_nodes: int) -> int:
    """'auto': 5 x max(1100 // num_nodes, 1) (reference lines 325, 328);
    else the integer given."""
    if num_samples == "auto":
        return 5 * max(1100 // num_nodes, 1)
    return int(num_samples)


def generate_for_molecule(ckpt: str, mol, num_samples, args, device=None,
                          logger=None):
    """(num_samples, N, 3) conformers of `mol` from the checkpoint `ckpt`
    with the sampler settings of `args` (parse_args's namespace)."""
    import torch

    from agdiff_torch.cli._common import load_inference_bundle
    from agdiff_torch.eval.generate import GenerationRunner
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import SamplerConfig

    config, model, _, _ = load_inference_bundle(ckpt, logger=logger)
    count = sample_count(num_samples, mol.num_nodes)
    scfg = SamplerConfig(
        n_steps=args.n_steps, step_lr=args.step_lr, w_global=args.w_global,
        global_start_sigma=args.global_start_sigma, clip=args.clip,
        clip_local=args.clip_local)
    runner = GenerationRunner(
        model, config.model, make_diffusion(config.model), scfg,
        buckets=config.buckets, chunk_size=args.chunk_size, device=device,
        engine=None if args.engine in (None, "xla") else args.engine,
        use_fast=args.fast, logger=logger)
    generator = torch.Generator(device=runner.device).manual_seed(args.seed)
    return runner.generate_molecule(mol, count, generator)


def main(argv=None):
    args = parse_args(argv)

    from agdiff_torch.chem import rdkit_bridge
    from agdiff_torch.utils.logging import get_logger

    logger = get_logger("smiles_generation")
    mol = rdkit_bridge.smiles_to_molecule(args.smiles, seed=args.seed)
    logger.info("%s -> %d atoms (with H)", args.smiles, mol.num_nodes)
    pos_gen = generate_for_molecule(args.ckpt, mol, args.num_samples, args,
                                    args.device, logger)
    rdkit_bridge.write_sdf(args.out_sdf, mol, pos_gen)
    logger.info("wrote %d conformers -> %s", len(pos_gen), args.out_sdf)
    return pos_gen


if __name__ == "__main__":
    main()
