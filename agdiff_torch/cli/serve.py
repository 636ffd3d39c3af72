"""Persistent generation server CLI (port of agdiff_tpu/cli/serve.py).

Loads a checkpoint once, warms the ladders it will serve (on the card,
their CUDA graphs: GenerationRunner.warm), then answers generation
requests over TCP (serve/server.py, the JAX service's protocol).

Server:
  python -m agdiff_torch.cli.serve (model.pt | <log_dir>) --port 7521 \
      --fast --packed --batch_window 0.2 --warm_nodes 23,29 \
      --max_nodes 32 [--engine tight-pksf] [--n_steps 5000] \
      [--device cpu]

Client (one JSON request, prints the JSON reply):
  python -m agdiff_torch.cli.serve --submit \
      '{"cmd": "generate", "test_set": "mols.npz", "out_dir": "out"}' \
      --port 7521

The sampler flags are fixed per server: they are baked into the
captured graphs. The checkpoint is a reference .pt or a log dir of
cli/train.py (cli/_common.py load_inference_bundle). --warm_set warms one
molecule of each class of a test set (serve/server.py warm_classes: on a
tight engine a class is a (bucket, capacity, atom count)); warmed graphs
stay for the server's life, and their pools' size is logged.
--num_devices N serves data-parallel over N ranks (parallel/mesh.py
launch: one card a rank over NCCL, or gloo ranks with --device cpu;
more ranks than cards raise): rank 0 listens, merges and replies, and
every chunk's graphs are split over the ranks (serve/server.py).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from agdiff_torch.cli.generate import ENGINE_CHOICES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", nargs="?", default=None,
                    help="log dir of cli/train.py, one of its checkpoint "
                         "directories, or a reference .pt; omit with "
                         "--submit (client mode)")
    ap.add_argument("--ckpt_iter", type=int, default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7521)
    ap.add_argument("--submit", default=None,
                    help="client mode: send this JSON request and print "
                         "the reply")
    ap.add_argument("--warm_nodes", default="",
                    help="comma list of molecule sizes (total atoms) to "
                         "warm at startup, e.g. 24,48")
    ap.add_argument("--warm_set", default=None,
                    help="warm from a test set (npz): one ladder set per "
                         "class its molecules map to")
    ap.add_argument("--warm_samples", type=int, default=None,
                    help="samples per molecule the warmed ladders cover "
                         "(default: one full chunk)")
    ap.add_argument("--warm_retry", action="store_true",
                    help="also warm the clip_local retry's ladders")
    # sampling flags: fixed per server (baked into the captured graphs)
    ap.add_argument("--n_steps", type=int, default=5000)
    ap.add_argument("--ladder", default="suffix",
                    choices=["suffix", "strided"])
    ap.add_argument("--step_lr", type=float, default=1e-6)
    ap.add_argument("--w_global", type=float, default=1.0)
    ap.add_argument("--global_start_sigma", type=float, default=0.5)
    ap.add_argument("--clip", type=float, default=1000.0)
    ap.add_argument("--clip_local", type=float, default=None)
    ap.add_argument("--clip_pos", type=float, default=None)
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
    ap.add_argument("--denoise_tail", type=int, default=0,
                    help="extra noise-free steps at the last noise level")
    ap.add_argument("--chunk_size", type=int, default=64)
    ap.add_argument("--num_devices", type=int, default=0,
                    help="data-parallel over this many ranks (0 = one "
                         "process, no group)")
    ap.add_argument("--engine", default=None, choices=ENGINE_CHOICES)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--ema", action="store_true",
                    help="sample with the EMA shadow weights (a run "
                         "trained with train.ema_decay > 0)")
    ap.add_argument("--batch_window", type=float, default=0.0,
                    help="dynamic batching: merge generate requests that "
                         "arrive within this many seconds into one packed "
                         "run (requires --packed; 0 = off); per-request "
                         "seeds keep each request's starts its own")
    ap.add_argument("--max_nodes", type=int, default=0,
                    help="reject generate requests whose molecules exceed "
                         "this many atoms ({'ok': false} reply, no device "
                         "work) instead of capturing new graphs "
                         "mid-request; 0 = accept any size")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.submit is not None:
        from agdiff_torch.serve.server import submit

        reply = submit(json.loads(args.submit), host=args.host,
                       port=args.port)
        print(json.dumps(reply))
        return 0 if reply.get("ok") else 1

    if not args.ckpt:
        ap.error("ckpt is required in server mode")
    if args.batch_window > 0 and not args.packed:
        ap.error("--batch_window requires --packed (cross-request packing "
                 "uses the PackedGenerationRunner)")
    if not args.num_devices:
        return serve(None, args)
    from agdiff_torch.parallel import launch

    return launch(serve, args.num_devices, args, device=args.device)


def serve(group, args) -> int:
    """The server of main's arguments, alone (group None) or as one rank
    of a data-parallel group: rank 0 serves, the others follow it."""
    from agdiff_torch.cli._common import get_logger, load_inference_bundle
    from agdiff_torch.eval.generate import (
        GenerationRunner,
        PackedGenerationRunner,
    )
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import SamplerConfig
    from agdiff_torch.serve.server import GenerationService, follow

    logger = get_logger("serve")
    config, model, ckpt_path, _ = load_inference_bundle(
        args.ckpt, args.ckpt_iter, args.dtype, logger, use_ema=args.ema)
    logger.info("checkpoint: %s", ckpt_path)
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
    if group is not None and not group.is_writer:
        follow(runner, logger)
        return 0
    service = GenerationService(runner, logger=logger,
                                batch_window_s=args.batch_window,
                                max_nodes=args.max_nodes or None)
    try:
        _warm_and_serve(args, runner, service, logger)
    finally:
        service.release_followers()
    return 0


def _warm_and_serve(args, runner, service, logger) -> None:
    from agdiff_torch.serve.server import probe_molecule, warm_classes

    if args.warm_nodes or args.warm_set:
        t0 = time.time()
        # a merged burst lands on any power-of-two batch size: warm all
        all_sizes = args.batch_window > 0
        todo = [(f"{n} atoms", probe_molecule(int(n)))
                for n in args.warm_nodes.split(",") if n]
        if args.warm_set:
            from agdiff_torch.data.dataset import PackedConformationDataset

            mols = PackedConformationDataset(args.warm_set).molecules
            todo += [(f"class {key}", m) for key, m in
                     sorted(warm_classes(runner, mols).items(),
                            key=lambda kv: str(kv[0]))]
        for label, mol in todo:
            with service.device_lock:
                captured = service.call("warm", mol,
                                        num_samples=args.warm_samples,
                                        retry=args.warm_retry,
                                        all_sizes=all_sizes)
            logger.info("warmed %s: %s", label, captured)
        logger.info("warm-up done in %.1fs: %d ladders, graph pools "
                    "%.1f MiB", time.time() - t0, runner.ladders(),
                    runner.warmed_pool_bytes() / 2 ** 20)
    service.serve(host=args.host, port=args.port)


if __name__ == "__main__":
    sys.exit(main())
