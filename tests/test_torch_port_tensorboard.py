"""The port's TensorBoard output and its loss history on the CPU: the
port's TensorBoardWriter against the JAX package's (the same scalar
stream reads back with the same tags, steps and values), both writers
silently inactive where torch.utils.tensorboard cannot be imported, the
port's Trainer against JAX's on one small config and data set (the same
tags at the same steps, the same learning rates, each event the
metrics.jsonl value rounded to float32), and the loss tensors the port's
Trainer keeps: at most one log interval of them during a run, none but
the last one's once `train` returns, and `Trainer.losses` the logged
losses float for float.

The losses of the two trainers are not compared: `jax.random` and
`torch.Generator` draw other timesteps and noise from one seed."""

import json
import os
import sys
import weakref

import jax
import numpy as np
import pytest
import yaml
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator,
)

from agdiff_tpu.config import load_config as jax_load_config
from agdiff_tpu.data.dataset import ConformationDataset as JaxDataset
from agdiff_tpu.models import dualenc as jax_dualenc
from agdiff_tpu.train import trainer as jax_trainer
from agdiff_tpu.utils.logging import TensorBoardWriter as JaxTensorBoard

from agdiff_torch.config import load_config
from agdiff_torch.data.dataset import ConformationDataset
from agdiff_torch.train.trainer import Trainer
from agdiff_torch.utils.logging import (
    MetricsWriter,
    MultiWriter,
    TensorBoardWriter,
)

from test_torch_port_common import (
    FAST_XLA,
    SMALL,
    jax_run,
    molecules,
    port_molecule,
)

ITERS = 6
VAL_FREQ = 3
TRAIN_TAGS = {"train/loss", "train/loss_global", "train/loss_local",
              "train/grad_norm", "train/lr_global", "train/lr_local"}
VAL_TAGS = {"val/loss", "val/loss_global", "val/loss_local"}


def _write_config(path, **train):
    raw = {"model": dict(SMALL),
           "train": {"seed": 3, "batch_size": 4, "val_freq": VAL_FREQ,
                     "max_iters": ITERS, "ema_decay": 0.9, **train},
           "buckets": {"max_nodes": [16]}}
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


def _events(log_dir):
    """{tag: [(step, value), ...]} of every event file in log_dir."""
    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def _metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _data(seed=2):
    mols = molecules(16, seed=seed)
    return mols[:12], mols[12:]


def _fast(jitted):
    """A jitted step compiled once per input shapes with FAST_XLA."""
    compiled = {}

    def call(*args):
        key = tuple((x.shape, x.dtype)
                    for x in jax.tree_util.tree_leaves(args))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options=FAST_XLA)
        return compiled[key](*args)
    return call


def _fast_init(init_model):
    """JAX's init_model with the init traced into one program compiled
    with FAST_XLA, where flax would run it op by op."""
    def init(config, key, max_nodes=32, batch=2):
        variables = jax_run(
            lambda k: init_model(config, k, max_nodes, batch)[1], key)
        return jax_dualenc.get_model(config), variables
    return init


def _port_set(mols):
    return ConformationDataset([port_molecule(m) for m in mols])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX Trainer run and one port Trainer run of the same config and
    molecules, log_freq 1: (JAX log dir, port log dir, port trainer)."""
    root = tmp_path_factory.mktemp("tensorboard")
    cfg = _write_config(root / "small.yml")
    train, val = _data()
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dualenc, "init_model",
                   _fast_init(jax_dualenc.init_model))
        # the orbax checkpoints at each validation are not read here
        mp.setattr(jax_trainer, "save_checkpoint", lambda *a, **k: None)
        reference = jax_trainer.Trainer(
            jax_load_config(cfg), JaxDataset(train), JaxDataset(val),
            jax_dir, log_freq=1)
        reference.train_step = _fast(reference.train_step)
        reference.eval_step = _fast(reference.eval_step)
        reference.train()
    trainer = Trainer(load_config(cfg), _port_set(train), _port_set(val),
                      port_dir, device="cpu", log_freq=1)
    trainer.train()
    return jax_dir, port_dir, trainer


def test_writer_events_equal_jax(tmp_path):
    """One scalar stream through both packages' writers reads back with
    the same tags, steps and values."""
    rng = np.random.default_rng(0)
    stream = [(step, {"train/loss": float(rng.normal()),
                      "train/lr_global": 10.0 ** -float(rng.integers(2, 5)),
                      "val/loss": float(rng.normal() * 1e3)})
              for step in (1, 2, 5, 9)]
    got = {}
    for name, cls in (("jax", JaxTensorBoard), ("port", TensorBoardWriter)):
        writer = cls(str(tmp_path / name))
        assert writer.active
        for step, scalars in stream:
            writer.write(step, scalars)
        writer.close()
        got[name] = _events(tmp_path / name)
    assert got["port"] == got["jax"]
    assert set(got["port"]) == set(stream[0][1])
    for tag, events in got["port"].items():
        assert events == [(step, float(np.float32(scalars[tag])))
                          for step, scalars in stream]


def test_writer_inactive_without_tensorboard(tmp_path, monkeypatch):
    """Without torch.utils.tensorboard both writers are inactive, write
    nothing and raise nothing; so is the port's without a log_dir."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for name, cls in (("jax", JaxTensorBoard), ("port", TensorBoardWriter)):
        log_dir = tmp_path / name
        log_dir.mkdir()
        writer = cls(str(log_dir))
        assert not writer.active
        writer.write(1, {"train/loss": 1.0})
        writer.close()
        assert os.listdir(log_dir) == []
    quiet = TensorBoardWriter(None)
    assert not quiet.active
    MultiWriter(quiet, None).write(1, {"train/loss": 1.0})


def test_writers_reopen_after_close(tmp_path):
    """A write after `close` (a Trainer's second train() call) appends to
    metrics.jsonl and starts a new event file beside the first."""
    writer = MultiWriter(MetricsWriter(str(tmp_path / "metrics.jsonl")),
                         TensorBoardWriter(str(tmp_path)))
    for step in (1, 2):
        writer.write(step, {"train/loss": float(step)})
        writer.close()
        writer.close()
    assert [line["step"] for line in _metrics(str(tmp_path))] == [1, 2]
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("events.out.tfevents.")]) == 2
    assert _events(tmp_path) == {"train/loss": [(1, 1.0), (2, 2.0)]}


def test_trainer_events_match_jax(runs):
    """The same tags at the same steps as JAX's Trainer, the same
    learning rates, and each event its metrics.jsonl value at float32."""
    jax_dir, port_dir, _ = runs
    want, got = _events(jax_dir), _events(port_dir)
    assert set(got) == set(want) == TRAIN_TAGS | VAL_TAGS
    for tag in got:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]], tag
    assert [s for s, _ in got["train/loss"]] == list(range(1, ITERS + 1))
    assert [s for s, _ in got["val/loss"]] == [VAL_FREQ, ITERS]
    for tag in ("train/lr_global", "train/lr_local"):
        assert got[tag] == want[tag]
    from_jsonl = {}
    for line in _metrics(port_dir):
        for tag, value in line.items():
            if tag != "step":
                from_jsonl.setdefault(tag, []).append(
                    (line["step"], float(np.float32(value))))
    assert got == from_jsonl


@pytest.mark.parametrize("log_freq,step_chunk,iters,at_logs", [
    (3, 1, 7, [1, 2, 3]),       # 2 x log_freq + 1; iteration 7 stays pending
    (4, 3, 18, [3, 3, 3, 3, 3]),  # a chunk past max(4, 3) flushes first
])
def test_loss_tensors_freed(tmp_path, log_freq, step_chunk, iters, at_logs):
    """At most max(log_freq, step_chunk) of the step's loss tensors are
    alive at any log point, none but the last step's once `train`
    returns; `losses` holds every iteration's, as floats."""
    cfg = _write_config(tmp_path / "small.yml", max_iters=iters,
                        step_chunk=step_chunk)
    train, _ = _data()
    trainer = Trainer(load_config(cfg), _port_set(train), None,
                      str(tmp_path / "logs"), device="cpu",
                      log_freq=log_freq)
    refs, alive_at_logs = [], []
    step, log = trainer.train_step, trainer._log

    def recording_step(state, batch):
        metrics = step(state, batch)
        refs.append(weakref.ref(metrics.loss))
        return metrics

    def recording_log(*args):
        alive_at_logs.append(sum(r() is not None for r in refs))
        log(*args)

    trainer.train_step, trainer._log = recording_step, recording_log
    trainer.train()
    assert len(refs) == iters
    assert alive_at_logs == at_logs
    assert max(alive_at_logs) <= max(log_freq, step_chunk)
    assert all(r() is None for r in refs[:-1])
    losses = trainer.losses
    assert len(losses) == iters and all(type(x) is float for x in losses)
    assert np.isfinite(losses).all()
    logged = {line["step"]: line["train/loss"]
              for line in _metrics(str(tmp_path / "logs"))}
    assert all(losses[it - 1] == v for it, v in logged.items())


def test_losses_are_the_logged_losses(runs):
    """At log_freq 1 `losses` is metrics.jsonl's train/loss column, float
    for float, and every step's loss tensor is freed."""
    _, port_dir, trainer = runs
    column = [line["train/loss"] for line in _metrics(port_dir)
              if "train/loss" in line]
    assert trainer.losses == column and len(column) == ITERS
