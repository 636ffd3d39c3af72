"""End-to-end learning demonstration on synthetic molecules (port of
examples/synthetic_end_to_end.py).

Trains the diffusion model on a synthetic conformer dataset, generates
conformers for held-out molecules with the Langevin sampler, and scores
COV/MAT, then does the same with the untrained model. The trained model
must beat the untrained one (MAT-R): the learn -> sample -> evaluate loop
in one script.

The settings are the JAX example's: hidden 64, 3 SchNet + 2 GIN
convolutions, 1000 timesteps, batch 64 at bucket 24; 3 conformers of each
of num_train tree-chemistry molecules (seed 0) to train on, the last
num_test of 1000 + num_test molecules (seed 1) to test; the ladder at
w_global 0.3, clip_local 20, 2x the reference conformers. The model is
drawn from seed 0 and the steps' timesteps and noise from a generator
seeded 1, where the JAX example takes PRNGKey(0) and PRNGKey(1). Training
is the port's train step; generation the port's GenerationRunner on its
default route (the f32 packed forward at this bucket); COV/MAT the port's
evaluator, on one process. The run is on the CUDA card unless --device
says otherwise.

  python -m agdiff_torch.examples.synthetic_end_to_end --iters 3000
  python -m agdiff_torch.examples.synthetic_end_to_end --iters 2 \\
      --timesteps 20 --num_train 8 --num_test 2 --hidden 32 --device cpu
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import time

import numpy as np

MAX_NODES = 24


def datasets(num_train: int, num_test: int):
    """(training conformers, test molecules): each of num_train molecules'
    3 noisy conformers as a datapoint of its own, and the last num_test of
    1000 + num_test held-out molecules with their 3 references."""
    from agdiff_torch.data.synthetic import synthetic_dataset

    base = synthetic_dataset(num_train, seed=0, min_heavy=4, max_heavy=6,
                             num_conformers=3)
    train_mols = []
    for m in base:
        for r in m.pos_ref.reshape(-1, m.num_nodes, 3):
            train_mols.append(dataclasses.replace(
                m, pos=r, pos_ref=None, meta=dict(m.meta)))
    test_mols = synthetic_dataset(1000 + num_test, seed=1, min_heavy=4,
                                  max_heavy=6, num_conformers=3)[-num_test:]
    return train_mols, test_mols


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--timesteps", type=int, default=1000)
    ap.add_argument("--num_train", type=int, default=192)
    ap.add_argument("--num_test", type=int, default=12)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", default="./synthetic_e2e")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from agdiff_torch.config import Config, ModelConfig, TrainConfig
    from agdiff_torch.data.dataset import BucketedLoader, ConformationDataset
    from agdiff_torch.device import resolve_device
    from agdiff_torch.eval.covmat import CovMatEvaluator
    from agdiff_torch.eval.generate import GenerationRunner
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import SamplerConfig
    from agdiff_torch.train.train_step import TrainStep, create_train_state
    from agdiff_torch.train.trainer import to_device

    device = resolve_device(args.device)
    cfg = Config(
        model=ModelConfig(hidden_dim=args.hidden, num_convs=3,
                          num_convs_local=2,
                          num_diffusion_timesteps=args.timesteps),
        train=TrainConfig(batch_size=args.batch))
    train_mols, test_mols = datasets(args.num_train, args.num_test)
    train_set = ConformationDataset(train_mols)
    print(f"train: {len(train_set)} conformers | test: {len(test_mols)} "
          f"mols ({device})")

    state = create_train_state(cfg, device, seed=0)
    state.generator = torch.Generator(device=device).manual_seed(1)
    untrained = copy.deepcopy(state.module.state_dict())
    loader = BucketedLoader(train_set, args.batch, buckets=(MAX_NODES,),
                            edge_order=cfg.model.edge_order, seed=0)
    step = TrainStep(cfg, device)
    t0 = time.time()
    for it in range(1, args.iters + 1):
        _, batch = loader.next_batch()
        metrics = step(state, to_device(batch, device))
        if it % 500 == 0 or it == 1:
            print(f"iter {it:5d} loss {float(metrics.loss):9.2f} "
                  f"({it / max(time.time() - t0, 1e-9):.1f} it/s)")
    train_s = time.time() - t0

    diffusion = make_diffusion(cfg.model)
    scfg = SamplerConfig(n_steps=args.timesteps, w_global=0.3,
                         clip_local=20.0)

    def evaluate(module, tag):
        runner = GenerationRunner(module, cfg.model, diffusion, scfg,
                                  buckets=(MAX_NODES,),
                                  chunk_size=args.batch, device=device)
        results = runner.run(test_mols, os.path.join(args.out, tag),
                             num_confs="2x", resume=False)
        res = CovMatEvaluator(num_workers=1)(results)
        cov_at_1 = float(np.mean(res.CoverageR[:, 19]))  # threshold 1.0 A
        mat = float(np.mean(res.MatchingR))
        print(f"[{tag}] COV-R@1.0A {cov_at_1:.3f} | MAT-R {mat:.3f} A")
        return cov_at_1, mat

    os.makedirs(args.out, exist_ok=True)
    fresh = DualEncoderEpsNetwork(cfg.model)
    fresh.load_state_dict(untrained)
    t0 = time.time()
    cov_u, mat_u = evaluate(fresh, "untrained")
    cov_t, mat_t = evaluate(state.module, "trained")
    print(f"\nRESULT: MAT-R untrained {mat_u:.3f} -> trained {mat_t:.3f} A | "
          f"COV-R@1A {cov_u:.3f} -> {cov_t:.3f} | training "
          f"{train_s:.1f} s, generation and scoring "
          f"{time.time() - t0:.1f} s")
    assert mat_t < mat_u, "training did not improve matching RMSD"
    print("LEARNING DEMONSTRATED")
    return dict(mat_untrained=mat_u, mat_trained=mat_t,
                cov_untrained=cov_u, cov_trained=cov_t, train_s=train_s)


if __name__ == "__main__":
    main()
