"""Progressive-distillation CLI (port of agdiff_tpu/cli/distill.py;
train/distill.py).

Distils a trained checkpoint into a few-step DDIM student, halving the
ladder stage by stage:

  python -m agdiff_torch.cli.distill <log_dir | checkpoint | model.pt> \\
      --ema_teacher --stages 64,32,16 --iters 1000 --synthetic 2048 \\
      --logdir distill_logs [--device cpu]

The teacher is a log dir of cli/train.py (its latest checkpoint, or
--ckpt_iter's), one of its checkpoint directories, a converted one of the
JAX package (convert_jax_checkpoint.py), or a reference .pt;
--ema_teacher takes the EMA shadow's parameters with the raw running
statistics; --dtype overrides the config's compute dtype. The student
trains with the teacher's config, its learning rate replaced by --lr and
no EMA. Each stage writes checkpoints of the training layout under
<logdir>/stage{n}/ (train/checkpoint.py), so the student samples and
serves unchanged:

  python -m agdiff_torch.cli.generate <logdir>/stage16 --fast \\
      --sampling_type generalized --eta 0 --ladder strided --n_steps 16 \\
      --w_global 0.3 --clip_local 20

The drift the student regresses is the sampling-time drift under the
flags --w_global, --global_start_sigma, --clip and --clip_local: sample
with the same flags. A rerun skips each stage that holds DONE.json (its
best student becomes the next teacher) and restarts an interrupted stage
from its latest checkpoint, the best validation loss read from its best
one; as in the JAX package only the student and its optimizer resume,
the data order and the draws restart (--no_resume retrains every stage).
Validation draws from a generator seeded seed + 7919 * n_student anew at
every validation, so its losses compare across iterations. The run is on
the CUDA card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", help="teacher: log dir or checkpoint path")
    ap.add_argument("--ckpt_iter", type=int, default=None)
    ap.add_argument("--logdir", default="./distill_logs")
    ap.add_argument("--stages", default="64,32,16,8",
                    help="comma-separated student step counts; each "
                         "stage's teacher is the previous stage's student "
                         "(the checkpoint for the first)")
    ap.add_argument("--iters", type=int, default=4000,
                    help="optimizer iterations per stage")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--batch_size", type=int, default=None,
                    help="default: config.train.batch_size")
    ap.add_argument("--step_chunk", type=int, default=None,
                    help="steps grouped between host checks (default: "
                         "config.train.step_chunk)")
    ap.add_argument("--val_freq", type=int, default=500)
    ap.add_argument("--ema_teacher", action="store_true",
                    help="start from the checkpoint's EMA shadow weights")
    ap.add_argument("--dtype", default=None,
                    choices=[None, "float32", "bfloat16"],
                    help="override the config's compute dtype")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--synthetic_rigid", action="store_true")
    ap.add_argument("--synthetic_heavy", type=int, default=None)
    ap.add_argument("--synthetic_chem", default="tree",
                    choices=["tree", "rich"])
    ap.add_argument("--synthetic_confs", type=int, default=1,
                    help="conformers per synthetic molecule, as separate "
                         "datapoints")
    ap.add_argument("--train_set", default=None,
                    help="npz dataset (instead of --synthetic)")
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--w_global", type=float, default=0.3)
    ap.add_argument("--global_start_sigma", type=float, default=0.5)
    ap.add_argument("--clip", type=float, default=1000.0)
    ap.add_argument("--clip_local", type=float, default=20.0)
    ap.add_argument("--weighting", default="trunc-snr",
                    choices=["trunc-snr", "eps", "step"],
                    help="per-step loss weight (train/distill.py)")
    ap.add_argument("--no_resume", action="store_true",
                    help="retrain every stage from scratch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if not args.synthetic and not args.train_set:
        ap.error("--train_set is required without --synthetic")

    import torch

    from agdiff_torch.cli._common import load_inference_bundle
    from agdiff_torch.data.dataset import (
        BucketedLoader,
        ConformationDataset,
        prefetch,
    )
    from agdiff_torch.device import resolve_device
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.sampling.langevin import SamplerConfig
    from agdiff_torch.train.checkpoint import (
        latest_checkpoint,
        load_best,
        load_checkpoint,
        save_checkpoint,
    )
    from agdiff_torch.train.distill import (
        create_distill_state,
        make_chunked_distill_step,
        make_distill_eval_step,
    )
    from agdiff_torch.train.optimizer import plateau_init
    from agdiff_torch.train.trainer import to_device
    from agdiff_torch.utils.logging import get_logger
    from agdiff_torch.utils.misc import seed_all

    os.makedirs(args.logdir, exist_ok=True)
    logger = get_logger("distill", args.logdir)
    seed_all(args.seed)
    device = resolve_device(args.device)

    config, teacher, ckpt_path, _ = load_inference_bundle(
        args.ckpt, args.ckpt_iter, args.dtype, logger,
        use_ema=args.ema_teacher)
    logger.info("teacher: %s", ckpt_path)
    # the student's optimizer; saved with each stage's checkpoints
    config = dataclasses.replace(
        config, train=dataclasses.replace(
            config.train,
            optimizer=dataclasses.replace(config.train.optimizer, lr=args.lr),
            ema_decay=0.0))
    teacher = teacher.to(device).eval().requires_grad_(False)

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
        mols = synthetic_dataset(args.synthetic, seed=args.seed,
                                 rigid=args.synthetic_rigid,
                                 chem=args.synthetic_chem, **kw)
        split = max(1, int(len(mols) * 0.9))
        tr_mols, va_mols = mols[:split], mols[split:]
        if args.synthetic_confs > 1:  # split by molecule, then expand
            tr_mols = expand_conformers(tr_mols, args.synthetic_confs,
                                        seed=args.seed + 1)
            va_mols = expand_conformers(va_mols, args.synthetic_confs,
                                        seed=args.seed + 2)
        train_set = ConformationDataset(tr_mols)
        val_set = ConformationDataset(va_mols)
    else:
        train_set = ConformationDataset(args.train_set)
        val_set = None
    logger.info("train: %d molecules | val: %d", len(train_set),
                len(val_set) if val_set else 0)

    batch_size = args.batch_size or config.train.batch_size
    chunk = (args.step_chunk if args.step_chunk is not None
             else max(1, int(config.train.step_chunk)))
    buckets = config.buckets
    needed = train_set.max_num_nodes()
    if needed > max(buckets):
        buckets = tuple(sorted(set(buckets) | {needed}))
    sampler_cfg = SamplerConfig(
        sampling_type="generalized", eta=0.0, ladder="strided",
        w_global=args.w_global, global_start_sigma=args.global_start_sigma,
        clip=args.clip, clip_local=args.clip_local)

    def module_from(state_dict):
        module = DualEncoderEpsNetwork(config.model)
        module.load_state_dict(state_dict)
        return module.to(device).eval().requires_grad_(False)

    def payload(state):
        return {"module": state.module.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}

    stages = [int(s) for s in args.stages.split(",")]
    resume = not args.no_resume
    # the step draws continue from stage to stage, as JAX's key does
    generator = torch.Generator(device=device).manual_seed(args.seed)
    summary = []
    for n_student in stages:
        stage_dir = os.path.join(args.logdir, f"stage{n_student}")
        os.makedirs(stage_dir, exist_ok=True)
        done_path = os.path.join(stage_dir, "DONE.json")
        if resume and os.path.exists(done_path):
            # finished by an earlier run: its best student is the next
            # stage's teacher, as if it had just trained
            with open(done_path) as fh:
                info = json.load(fh)
            teacher = module_from(load_best(stage_dir)["module"])
            summary.append({"stage": n_student,
                            "best_val": info["best_val"],
                            "dir": stage_dir, "resumed": True})
            logger.info("[stage %d] already complete (best val %.6f) — "
                        "skipping", n_student, info["best_val"])
            continue
        logger.info("=== stage: %d student steps (teacher ladder %d) ===",
                    n_student, 2 * n_student)
        state = create_distill_state(config, teacher, device, args.seed)
        state.generator = generator
        steps = make_chunked_distill_step(config, sampler_cfg, n_student,
                                          device, args.weighting)
        eval_step = make_distill_eval_step(config, sampler_cfg, n_student,
                                           device, args.weighting)
        loader = BucketedLoader(train_set, batch_size, buckets,
                                edge_order=config.model.edge_order,
                                seed=args.seed)
        val_loader = (BucketedLoader(val_set, batch_size, buckets,
                                     edge_order=config.model.edge_order,
                                     seed=args.seed, shuffle=False,
                                     drop_last=False)
                      if val_set is not None else None)

        def draws(loader=loader):
            while True:
                yield loader.next_batch()

        data = prefetch(draws(), size=max(2, 2 * chunk),
                        pin=device.type == "cuda")
        val_seed = args.seed + 7919 * n_student

        def validate(it, state, n_student=n_student, eval_step=eval_step,
                     val_loader=val_loader, val_seed=val_seed):
            vgen = torch.Generator(device=device).manual_seed(val_seed)
            sums = {"sum_loss": 0.0, "count": 0.0}
            for _, batch in val_loader.epoch_batches():
                out = eval_step(state, teacher, batch.to(device), vgen)
                for name in sums:
                    sums[name] += float(out[name])
            avg = sums["sum_loss"] / max(sums["count"], 1.0)
            logger.info("[stage %d] [Validate] Iter %05d | Loss %.6f",
                        n_student, it, avg)
            return avg

        best_val, best_module = float("inf"), None
        start_it = 1
        if resume:
            try:
                ck_path, ck_it = latest_checkpoint(stage_dir)
            except FileNotFoundError:
                ck_path = None
            if ck_path is not None:
                loaded = load_checkpoint(ck_path, map_location=device)
                state.module.load_state_dict(loaded["module"])
                state.optimizer.load_state_dict(loaded["optimizer"])
                state.step = int(loaded["step"])
                best = load_best(stage_dir)
                best_val = float(best["avg_val_loss"])
                best_module = best["module"]
                start_it = ck_it + 1
                logger.info("[stage %d] resuming from iter %d (best val "
                            "%.6f)", n_student, ck_it, best_val)
        t0, it = time.time(), start_it
        try:
            while it <= args.iters:
                k = min(chunk, args.iters - it + 1)
                metrics = steps(state, teacher, [
                    to_device(next(data)[1], device) for _ in range(k)])
                prev, it = it, it + k - 1
                if it // 200 != (prev - 1) // 200 or prev == 1:
                    logger.info(
                        "[stage %d] Iter %05d | Loss %.5f | Grad %.3f | "
                        "%.1f it/s", n_student, it, float(metrics.loss),
                        float(metrics.grad_norm),
                        200 / max(time.time() - t0, 1e-9))
                    t0 = time.time()
                if val_loader is not None and (
                        it // args.val_freq != (prev - 1) // args.val_freq
                        or it == args.iters):
                    avg = validate(it, state)
                    best = avg < best_val
                    if best:
                        best_val = avg
                        best_module = {n: t.detach().clone() for n, t in
                                       state.module.state_dict().items()}
                    save_checkpoint(stage_dir, it, config, payload(state),
                                    plateau_init(args.lr),
                                    plateau_init(args.lr), avg, best=best)
                it += 1
        finally:
            data.close()
        if val_loader is None:
            save_checkpoint(stage_dir, args.iters, config, payload(state),
                            plateau_init(args.lr), plateau_init(args.lr),
                            float("nan"), best=True)
        # the next stage's teacher is this stage's best student
        teacher = module_from(best_module if best_module is not None
                              else state.module.state_dict())
        with open(done_path, "w") as fh:
            json.dump({"stage": n_student, "best_val": best_val,
                       "iters": args.iters}, fh)
        summary.append({"stage": n_student, "best_val": best_val,
                        "dir": stage_dir})
        logger.info("[stage %d] done | best val %.6f -> %s",
                    n_student, best_val, stage_dir)

    with open(os.path.join(args.logdir, "STAGES.json"), "w") as fh:
        json.dump({"stages": summary, "weighting": args.weighting,
                   "sampler": dataclasses.asdict(sampler_cfg)}, fh,
                  indent=1)
    logger.info("distillation complete: %s", args.logdir)
    return summary


if __name__ == "__main__":
    main()
