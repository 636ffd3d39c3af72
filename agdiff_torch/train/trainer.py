"""The training loop (port of agdiff_tpu/train/trainer.py:43-264;
reference: scripts/train.py:23-260).

An infinite shuffled loader (collated on a background thread, into pinned
memory on a card), a step an iteration (train.step_chunk groups K
batches, run as K eager steps: the values of K single steps, where the
JAX package scans them in one program), metrics every log_freq
iterations (to <log_dir>/metrics.jsonl and, where the `tensorboard`
package is installed, to TensorBoard event files beside it), validation
every val_freq iterations and at the last one (both plateau controllers
step on it: the global Adam's on the global loss, the local one's on the
local loss), a checkpoint at each validation with best-model tracking,
and `resume(log_dir, it)` (of a port run, or of a JAX run's converted
checkpoint). A port checkpoint holds the step generator's and the
loader's state, so a resumed run continues the uninterrupted one's
draws: j iterations after a resume from checkpoint k equal iterations
k + 1 .. k + j of the uninterrupted run (bit for bit, on a card under
torch.use_deterministic_algorithms).

`Trainer.losses` holds every iteration's loss. The step's loss tensors
stay on the device for one log interval at most (log_freq iterations, or
one step_chunk where that is larger): at each log point, and when
`train` returns, they go to the host in one copy, into an array of
8 bytes an iteration.

`model.dtype: bfloat16` trains the module at bf16 compute with f32
parameters, f32 BatchNorm statistics and an f32 loss, as the JAX package
does (models/dualenc.py, nn/common.py).

With a data-parallel `group` (cli/train.py --num_devices; JAX's `mesh`,
agdiff_tpu/train/trainer.py:89-92, :166-200) every rank runs the same
seeded loader and takes its shard of each batch
(parallel/data_parallel.py), so the loader state in a checkpoint is the
single run's; the step is the global batch's (train/train_step.py).
Every rank validates (its draws keep the step generators equal), and
rank 0's three validation losses go to every rank, whose plateau
controllers then take the same decision; rank 0 alone writes
checkpoints, metrics (JSONL and TensorBoard) and the log. Every rank
resumes from the same checkpoint, and before the first step every rank's
parameters are checked equal to rank 0's.
"""

from __future__ import annotations

import logging
import os
import time
from array import array
from typing import Optional

import torch

from agdiff_torch.config import Config
from agdiff_torch.data.dataset import (
    BucketedLoader,
    ConformationDataset,
    prefetch,
)
from agdiff_torch.data.graph_batch import GraphBatch
from agdiff_torch.device import resolve_device
from agdiff_torch.parallel.data_parallel import check_replicas
from agdiff_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from agdiff_torch.train.optimizer import plateau_init, scheduler_step
from agdiff_torch.train.train_step import (
    TrainState,
    TrainStep,
    create_train_state,
    make_eval_step,
)
from agdiff_torch.utils.logging import (
    MetricsWriter,
    MultiWriter,
    TensorBoardWriter,
    get_logger,
)


def to_device(batch: GraphBatch, device) -> GraphBatch:
    """Copy a (pinned) host batch to the device without blocking."""
    return GraphBatch(**{k: v.to(device, non_blocking=True)
                         for k, v in vars(batch).items()})


def restore_state(state: TrainState, ckpt: dict) -> None:
    """A checkpoint's payload (load_checkpoint) into `state`, in place:
    the module, both Adams, the step, the EMA shadow and the step
    generator. A converted checkpoint of the JAX package holds no
    generator state (the JAX package saves none): the generator then
    keeps a fresh run's seed, train.seed, as the JAX package's resume
    restarts its key from PRNGKey(train.seed) (agdiff_tpu/train/
    trainer.py:83-84, 104-118)."""
    state.module.load_state_dict(ckpt["module"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    if state.ema is not None:
        for name, t in state.ema.items():
            t.copy_(ckpt["ema"][name])
    if "generator" in ckpt:
        state.generator.set_state(ckpt["generator"].cpu())


class Trainer:
    def __init__(self, config: Config, train_set: ConformationDataset,
                 val_set: Optional[ConformationDataset], log_dir: str,
                 logger: Optional[logging.Logger] = None, device=None,
                 log_freq: int = 100, group=None):
        self.config = config
        self.log_dir = log_dir
        self.group = group
        self.is_writer = group is None or group.is_writer
        if self.is_writer:
            os.makedirs(log_dir, exist_ok=True)
            self.logger = logger or get_logger("train", log_dir)
        else:
            self.logger = logging.getLogger("train.rank")
            self.logger.disabled = True
        self.writer = MultiWriter(
            MetricsWriter(os.path.join(log_dir, "metrics.jsonl")
                          if self.is_writer else None),
            TensorBoardWriter(log_dir if self.is_writer else None))
        self.device = group.device if group else resolve_device(device)
        self.log_freq = log_freq
        if group is not None:
            group.rows(config.train.batch_size)   # raises unless it splits

        buckets = config.buckets
        needed = train_set.max_num_nodes()
        if needed > max(buckets):
            buckets = tuple(sorted(set(buckets) | {needed}))
        self.train_loader = BucketedLoader(
            train_set, config.train.batch_size, buckets,
            edge_order=config.model.edge_order, seed=config.train.seed)
        self.val_loader = (BucketedLoader(
            val_set, config.train.batch_size, buckets,
            edge_order=config.model.edge_order, seed=config.train.seed,
            shuffle=False, drop_last=False) if val_set is not None else None)
        self.state: TrainState = create_train_state(config, self.device)
        self.train_step = TrainStep(config, self.device, group)
        self.eval_step = make_eval_step(config, self.device)
        lr = config.train.optimizer.lr
        self.plateau_global = plateau_init(lr)
        self.plateau_local = plateau_init(lr)
        self.start_iter = 1
        self.best_val_loss = float("inf")
        self._pending = []  # this log interval's losses, on the device
        self._history = array("d")  # every earlier iteration's, on the host

    # --- resume (reference: train.py:104-115) ---
    def resume(self, resume_dir: str, it: Optional[int] = None) -> None:
        path, iteration = latest_checkpoint(resume_dir, it)
        self.logger.info("Resuming from: %s (iteration %d)", path, iteration)
        ckpt = load_checkpoint(path, map_location=self.device)
        restore_state(self.state, ckpt)
        # a converted checkpoint of the JAX package holds no loader state
        # (the JAX package saves none): the loader then starts at its first
        # draw, as the JAX package's resume restarts its loader
        if "loader" in ckpt:
            self.train_loader.load_state_dict(ckpt["loader"])
        self.plateau_global = ckpt["plateau_global"]
        self.plateau_local = ckpt["plateau_local"]
        self.best_val_loss = ckpt["avg_val_loss"]
        self.start_iter = iteration + 1
        self._apply_lrs()

    def _apply_lrs(self) -> None:
        self.state.optimizer.set_learning_rates(self.plateau_global.lr,
                                                self.plateau_local.lr)

    def _payload(self, loader_state) -> dict:
        st = self.state
        payload = {"module": st.module.state_dict(),
                   "optimizer": st.optimizer.state_dict(), "step": st.step,
                   "generator": st.generator.get_state(),
                   "loader": loader_state}
        if st.ema is not None:
            payload["ema"] = st.ema
        return payload

    def _val_losses(self):
        """(loss, global, local) over the validation set."""
        sums = {"sum_loss": 0.0, "sum_global": 0.0, "sum_local": 0.0,
                "count": 0.0}
        for _, batch in self.val_loader.epoch_batches():
            out = self.eval_step(self.state, batch.to(self.device))
            for name in sums:
                sums[name] += float(out[name])
        count = max(sums["count"], 1.0)
        return (sums["sum_loss"] / count, sums["sum_global"] / count,
                sums["sum_local"] / count)

    def validate(self, it: int) -> float:
        assert self.val_loader is not None
        # every rank validates (the draws keep the step generators equal),
        # and rank 0's reading goes bit for bit (float64) to every rank
        avg, avg_global, avg_local = self._val_losses()
        if self.group is not None:
            vals = torch.tensor((avg, avg_global, avg_local),
                                dtype=torch.float64, device=self.device)
            avg, avg_global, avg_local = self.group.broadcast(vals).tolist()
        sched = self.config.train.scheduler
        self.plateau_global = scheduler_step(self.plateau_global,
                                             avg_global, sched)
        self.plateau_local = scheduler_step(self.plateau_local, avg_local,
                                            sched)
        self._apply_lrs()
        self.logger.info(
            "[Validate] Iter %05d | Loss %.6f | Loss(Global) %.6f | "
            "Loss(Local) %.6f", it, avg, avg_global, avg_local)
        self.writer.write(it, {"val/loss": avg, "val/loss_global": avg_global,
                               "val/loss_local": avg_local})
        return avg

    def _place(self, batch: GraphBatch) -> GraphBatch:
        """A host batch on the device: this rank's shard under a group."""
        if self.group is None:
            return to_device(batch, self.device)
        return self.group.shard(batch)

    def _draws(self):
        """(bucket, batch, loader state after it), forever."""
        while True:
            bucket, batch = self.train_loader.next_batch()
            yield bucket, batch, self.train_loader.state_dict()

    def train(self, max_iters: Optional[int] = None) -> TrainState:
        cfg = self.config.train
        max_iters = max_iters or cfg.max_iters
        chunk = max(1, int(cfg.step_chunk))
        data = prefetch(self._draws(), size=max(2, 2 * chunk),
                        pin=self.device.type == "cuda")
        loader_state = self.train_loader.state_dict()
        if self.group is not None:
            check_replicas(self.state.module, self.group)
        t_start = time.time()
        try:
            it = self.start_iter
            while it <= max_iters:
                k = min(chunk, max_iters - it + 1)
                if len(self._pending) + k > max(self.log_freq, chunk):
                    self._flush_losses()  # step_chunk does not divide log_freq
                drawn = [next(data) for _ in range(k)]
                loader_state = drawn[-1][2]
                batches = [self._place(b) for _, b, _ in drawn]
                for batch in batches:
                    metrics = self.train_step(self.state, batch)
                    self._pending.append(metrics.loss)
                prev, it = it, it + k - 1
                if it // self.log_freq != (prev - 1) // self.log_freq \
                        or prev == 1:
                    self._log(it, metrics, t_start)
                    self._flush_losses()
                    t_start = time.time()
                if self.val_loader is not None and (
                        it // cfg.val_freq != (prev - 1) // cfg.val_freq
                        or it == max_iters):
                    avg_val_loss = self.validate(it)
                    best = avg_val_loss < self.best_val_loss
                    if best:
                        self.best_val_loss = avg_val_loss
                        self.logger.info("New best model saved with loss %f",
                                         avg_val_loss)
                    if self.is_writer:
                        save_checkpoint(
                            self.log_dir, it, self.config,
                            self._payload(loader_state),
                            self.plateau_global, self.plateau_local,
                            avg_val_loss, best=best)
                it += 1
        except KeyboardInterrupt:
            self.logger.info("Terminating...")
        finally:
            data.close()
            self.writer.close()
        self._flush_losses()
        return self.state

    def _flush_losses(self) -> None:
        """The pending loss tensors to the host history, in one copy."""
        if self._pending:
            self._history.extend(torch.stack(self._pending).tolist())
            self._pending.clear()

    @property
    def losses(self):
        """Every iteration's loss of this trainer's runs, as floats."""
        self._flush_losses()
        return self._history.tolist()

    def _log(self, it: int, metrics, t_start: float) -> None:
        vals = {"train/loss": float(metrics.loss),
                "train/loss_global": float(metrics.loss_global),
                "train/loss_local": float(metrics.loss_local),
                "train/grad_norm": float(metrics.grad_norm),
                "train/lr_global": self.plateau_global.lr,
                "train/lr_local": self.plateau_local.lr}
        self.logger.info(
            "[Train] Iter %05d | Loss %.2f | Loss(Global) %.2f | "
            "Loss(Local) %.2f | Grad %.2f | LR(Global) %.6f | "
            "LR(Local) %.6f | %.1f it/s", it, vals["train/loss"],
            vals["train/loss_global"], vals["train/loss_local"],
            vals["train/grad_norm"], self.plateau_global.lr,
            self.plateau_local.lr,
            self.log_freq / max(time.time() - t_start, 1e-9))
        self.writer.write(it, vals)
