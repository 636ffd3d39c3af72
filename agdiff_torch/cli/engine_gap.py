"""A bf16 engine's score planes against the f32 engine's on a checkpoint:
the reading behind chip_smoke.py's engine limits (5%, the JAX package's
slim gate), taken on trained weights instead of random ones.

Usage:
  python -m agdiff_torch.cli.engine_gap <log_dir> [--ema] [--engine pksf]
      [--synthetic 60] [--sigmas 0,0.1,0.5,2] [--device cpu]

The molecules are the generation CLI's held-out synthetic ones (seed 7,
three reference conformers). Each molecule, repeated --chunk times in its
bucket, at each of its reference conformers plus Gaussian noise of each
sigma (the ladder's range), goes through both engines; per score plane,
on its mask, max |bf16 - f32| over max |f32|. Prints one JSON line: the
largest and the median of those ratios per plane, and the largest per
sigma. The K1 engines (pks, pksg, pksf, over the bucket's triu pairs) are
read; the tight ones are not.
"""

from __future__ import annotations

import argparse
import json
import statistics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", help="log dir, checkpoint directory or .pt")
    ap.add_argument("--ckpt_iter", type=int, default=None)
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--engine", default="pksf",
                    choices=["pks", "pksg", "pksf", "pksf-approx"])
    ap.add_argument("--synthetic", type=int, default=60)
    ap.add_argument("--synthetic_heavy", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--sigmas", default="0,0.1,0.5,2")
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    from agdiff_torch.cli._common import load_inference_bundle
    from agdiff_torch.data.bucketing import pad_molecules, pick_bucket
    from agdiff_torch.data.synthetic import heavy_range, synthetic_dataset
    from agdiff_torch.device import resolve_device
    from agdiff_torch.models.fast_forward import build_fast_forward

    dev = resolve_device(args.device)
    config, model, path, it = load_inference_bundle(
        args.ckpt, args.ckpt_iter, use_ema=args.ema)
    model = model.to(dev)
    f32 = dataclasses.replace(config.model, dtype="float32")
    engine = build_fast_forward(config.model, model, args.engine)
    plain = build_fast_forward(f32, model, None)
    kw = {}
    if args.synthetic_heavy is not None:
        lo, hi = heavy_range(args.synthetic_heavy)
        kw = dict(min_heavy=lo, max_heavy=hi)
    mols = synthetic_dataset(args.synthetic, seed=7, num_conformers=3, **kw)
    sigmas = [float(x) for x in args.sigmas.split(",")]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    ratios = {"edge_inv_global": [], "edge_inv_local": []}
    per_sigma = {s: 0.0 for s in sigmas}
    with torch.no_grad():
        for mol in mols:
            bucket = pick_bucket(mol.num_nodes, config.buckets)
            if bucket >= 40:
                raise ValueError(f"{mol.num_nodes} atoms: bucket {bucket} "
                                 f"takes a tight engine, not read here")
            batch = pad_molecules([mol] * args.chunk, bucket, device=dev)
            refs = torch.as_tensor(mol.pos_ref, device=dev).reshape(
                -1, mol.num_nodes, 3)
            for sigma in sigmas:
                pos = batch.pos.clone()
                pos[:, :mol.num_nodes] = refs[
                    torch.arange(args.chunk, device=dev) % len(refs)]
                pos = pos + sigma * torch.randn(
                    pos.shape, generator=gen, device=dev) \
                    * batch.node_mask[..., None]
                b = batch.replace(pos=pos)
                out_k, out_f = engine(b), plain(b)
                for key, mask in (("edge_inv_global", out_f.edge_mask),
                                  ("edge_inv_local", out_f.local_mask)):
                    ref = torch.where(mask, getattr(out_f, key), 0.0)
                    got = torch.where(mask, getattr(out_k, key), 0.0)
                    r = float((got - ref).abs().max()) / max(
                        float(ref.abs().max()), 1e-6)
                    ratios[key].append(r)
                    per_sigma[sigma] = max(per_sigma[sigma], r)
    row = {"checkpoint": path, "iteration": it, "ema": args.ema,
           "engine": args.engine, "molecules": len(mols),
           "chunk": args.chunk, "device": str(dev),
           "max_rel": {k: max(v) for k, v in ratios.items()},
           "median_rel": {k: statistics.median(v) for k, v in ratios.items()},
           "max_rel_per_sigma": {str(s): r for s, r in per_sigma.items()}}
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
