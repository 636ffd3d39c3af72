"""The CLIs' --num_devices on the CPU (two gloo ranks each, spawned by
`agdiff_torch.parallel.launch`) against their single-process runs:
`cli.train` for 3 iterations (its losses those of the run without the
flag) and a resume that continues it bit for bit, `cli.generate` from
its log dir (samples those of `--num_devices 0`), two requests merged by
a two-rank `cli.serve` (each request's samples those of a single-process
packed run of it alone), a two-rank server that stays idle past the
world's collective timeout and answers again, and the refusals: more
ranks than cards, NCCL off the cards, a rank that dies.

Tolerances: losses LOSS_RTOL relative; positions POS_ATOL (a forward on
a rank's half of a chunk may round otherwise than on the whole chunk in
the CPU's BLAS; a merged chunk is larger than a request's own)."""

import importlib.util
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch
import yaml
from torch.multiprocessing.spawn import ProcessException

from agdiff_torch.cli import generate as gen_cli
from agdiff_torch.cli import serve as serve_cli
from agdiff_torch.cli import train as train_cli
from agdiff_torch.cli._common import load_inference_bundle
from agdiff_torch.data.synthetic import heavy_range, synthetic_dataset
from agdiff_torch.eval.generate import PackedGenerationRunner, load_samples
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.parallel import launch, mesh
from agdiff_torch.parallel.mesh import free_port
from agdiff_torch.sampling.langevin import SamplerConfig
from agdiff_torch.serve.server import submit
from agdiff_torch.train.checkpoint import load_checkpoint

import torch_port_dp_ranks as ranks
from test_torch_port_common import SMALL

SYNTH = ["--synthetic", "16", "--synthetic_heavy", "5", "--device", "cpu"]
DP = ["--num_devices", "2"]
LOSS_RTOL = 1e-5
POS_ATOL = 1e-4
ITERS = 3
LADDER = dict(n_steps=3, ladder="strided", sampling_type="generalized",
              eta=0.0)
TIMEOUT = 120     # seconds: each client call and the server's start
SHORT_TIMEOUT_S = 8.0   # the world's collective timeout, cut for one test


def _write_config(path):
    raw = {"model": dict(SMALL),
           "train": {"seed": 3, "batch_size": 4, "val_freq": 2,
                     "max_iters": ITERS, "ema_decay": 0.9},
           "buckets": {"max_nodes": [16]}}
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The data-parallel run (checkpoints 2 and 3), the same run in one
    process, and the data-parallel run resumed from checkpoint 2, all
    under --deterministic."""
    root = tmp_path_factory.mktemp("dp_train")
    cfg = _write_config(root / "small.yml")
    try:
        dp = train_cli.main([cfg, "--logdir", str(root / "dp"),
                             "--deterministic", *DP, *SYNTH])
        single = train_cli.main([cfg, "--logdir", str(root / "single"),
                                 "--deterministic", *SYNTH])
        resumed_dir = str(root / "resumed")
        shutil.copytree(dp.log_dir, resumed_dir)
        shutil.rmtree(os.path.join(resumed_dir, "checkpoints", str(ITERS)))
        resumed = train_cli.main([resumed_dir, "--resume_iter", "2",
                                  "--deterministic", *DP, *SYNTH])
    finally:
        torch.use_deterministic_algorithms(False)
    return root, dp, single, resumed


def test_dp_training_follows_the_single_process_run(runs):
    _, dp, single, _ = runs
    assert isinstance(dp, train_cli.TrainRun)
    assert len(dp.losses) == ITERS and np.isfinite(dp.losses).all()
    np.testing.assert_allclose(dp.losses, single.losses, rtol=LOSS_RTOL)
    assert sorted(os.listdir(os.path.join(dp.log_dir, "checkpoints"))) == \
        ["2", "3"]
    # rank 0 alone logs: one metrics line a logged or validated iteration
    with open(os.path.join(dp.log_dir, "metrics.jsonl")) as f:
        dp_lines = [json.loads(x)["step"] for x in f]
    with open(os.path.join(single.log_dir, "metrics.jsonl")) as f:
        assert dp_lines == [json.loads(x)["step"] for x in f]
    # and alone writes TensorBoard events (where tensorboard is installed):
    # every event file's name ends in <pid>.<n>, all of one process
    pids = {f.rsplit(".", 2)[1] for f in os.listdir(dp.log_dir)
            if f.startswith("events.out.tfevents.")}
    assert len(pids) == (1 if importlib.util.find_spec("tensorboard")
                         else 0), pids


def test_dp_resume_continues_bit_for_bit(runs):
    _, dp, _, resumed = runs
    assert resumed.losses == dp.losses[2:]
    a = load_checkpoint(os.path.join(dp.log_dir, "checkpoints", str(ITERS)))
    b = load_checkpoint(os.path.join(resumed.log_dir, "checkpoints",
                                     str(ITERS)))
    for part in ("module", "ema"):
        for key in a[part]:
            assert torch.equal(a[part][key], b[part][key]), (part, key)
    for part in ("global", "local"):
        oa, ob = a["optimizer"]["adams"][part], b["optimizer"]["adams"][part]
        assert oa["count"] == ob["count"] == ITERS
        for x, y in zip(oa["mu"] + oa["nu"], ob["mu"] + ob["nu"]):
            assert torch.equal(x, y)
    assert torch.equal(a["generator"], b["generator"])
    assert a["loader"]["cursor"] == b["loader"]["cursor"]
    assert a["loader"]["rng"] == b["loader"]["rng"]


def test_dp_generate_equals_one_process(runs):
    root, dp, _, _ = runs
    args = [dp.log_dir, "--synthetic", "2", "--synthetic_heavy", "4",
            "--n_steps", "3", "--end_idx", "2", "--device", "cpu"]
    outs = {}
    for label, extra in (("dp", DP), ("one", [])):
        out = str(root / f"samples_{label}")
        assert gen_cli.main([*args, "--out_dir", out, *extra]) == out
        outs[label] = load_samples(os.path.join(out, "samples_all.npz"))
    assert len(outs["dp"]) == 2
    for a, b in zip(outs["dp"], outs["one"]):
        assert a.meta["pos_gen"].shape == b.meta["pos_gen"].shape == (
            6, a.num_nodes, 3)
        np.testing.assert_allclose(a.meta["pos_gen"], b.meta["pos_gen"],
                                   atol=POS_ATOL)
    # rank 0 alone wrote: one log, one file a molecule
    assert sorted(os.listdir(root / "samples_dp")) == [
        "log.txt", "samples_0.npz", "samples_1.npz", "samples_all.npz"]


def _wait_for(port):
    deadline = time.time() + TIMEOUT
    while True:
        try:
            return submit({"cmd": "ping"}, port=port, timeout=TIMEOUT)
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.5)


def test_two_requests_through_a_two_rank_server(runs):
    _, dp, _, _ = runs
    port = free_port()
    flags = [f"--{k}={v}" for k, v in LADDER.items()]
    box = []
    thread = threading.Thread(target=lambda: box.append(serve_cli.main([
        dp.log_dir, "--port", str(port), "--fast", "--packed",
        "--batch_window", "1.0", "--chunk_size", "8", "--warm_nodes", "16",
        *flags, *DP, "--device", "cpu"])), daemon=True)
    thread.start()
    try:
        assert _wait_for(port)["ok"]
        requests = [dict(cmd="generate", synthetic=2, synthetic_heavy=4,
                         seed=seed, num_confs=3, save=False,
                         return_pos=True) for seed in (5, 6)]
        replies = [None, None]

        def client(i):
            replies[i] = submit(requests[i], port=port, timeout=TIMEOUT)

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=TIMEOUT)
        assert all(r and r["ok"] for r in replies), replies
        assert [r["batched_with"] for r in replies] == [1, 1]
    finally:
        submit({"cmd": "shutdown"}, port=port, timeout=TIMEOUT)
        thread.join(timeout=TIMEOUT)
    assert not thread.is_alive() and box == [0]
    # each request's samples: those of a single-process run of it alone
    config, model, _, _ = load_inference_bundle(dp.log_dir)
    runner = PackedGenerationRunner(
        model, config.model, make_diffusion(config.model),
        SamplerConfig(**LADDER), buckets=config.buckets, chunk_size=8,
        device="cpu")
    lo, hi = heavy_range(4)
    mols = synthetic_dataset(2, seed=7, num_conformers=3, min_heavy=lo,
                             max_heavy=hi)
    for request, reply in zip(requests, replies):
        alone = runner.run(mols, None, num_confs=[3, 3],
                           item_seeds=[(request["seed"], k)
                                       for k in range(2)], save=False)
        for m, pos in zip(alone, reply["pos"]):
            np.testing.assert_allclose(np.asarray(pos, np.float32),
                                       m.meta["pos_gen"], atol=POS_ATOL)


def test_a_two_rank_server_outlives_the_collective_timeout(runs,
                                                          monkeypatch):
    """The world's collectives fail after INIT_TIMEOUT_S, cut here to
    SHORT_TIMEOUT_S; the follower waits longer than that between two
    requests, in the control group, and both requests are answered."""
    _, dp, _, _ = runs
    monkeypatch.setattr(mesh, "INIT_TIMEOUT_S", SHORT_TIMEOUT_S)
    port = free_port()
    box = []
    thread = threading.Thread(target=lambda: box.append(serve_cli.main([
        dp.log_dir, "--port", str(port), "--fast", "--chunk_size", "8",
        *[f"--{k}={v}" for k, v in LADDER.items()], *DP,
        "--device", "cpu"])), daemon=True)
    thread.start()
    request = dict(cmd="generate", synthetic=1, synthetic_heavy=4, seed=5,
                   num_confs=2, save=False)
    try:
        assert _wait_for(port)["ok"]
        first = submit(request, port=port, timeout=TIMEOUT)
        time.sleep(SHORT_TIMEOUT_S + 4)
        second = submit(request, port=port, timeout=TIMEOUT)
        assert first["ok"] and second["ok"], (first, second)
    finally:
        submit({"cmd": "shutdown"}, port=port, timeout=TIMEOUT)
        thread.join(timeout=TIMEOUT)
    assert not thread.is_alive() and box == [0]


def test_refusals_without_fallback():
    """More ranks than cards, NCCL on the CPU or on one shared card, and a
    rank that dies: each raises in the launching process."""
    too_many = (torch.cuda.device_count() if torch.cuda.is_available()
                else 0) + 1
    with pytest.raises(ValueError, match=f"requested {too_many} devices"):
        launch(ranks.die_on_rank_1, too_many)
    with pytest.raises(ValueError, match=f"requested {too_many} devices"):
        train_cli.main(["missing.yml", "--num_devices", str(too_many)])
    with pytest.raises(ValueError, match="gloo"):
        launch(ranks.die_on_rank_1, 2, device="cpu", backend="nccl")
    # whichever rank the launcher hears from first: rank 1's error, or
    # rank 0's collective that lost its peer
    with pytest.raises(ProcessException):
        launch(ranks.die_on_rank_1, 2, device="cpu")
