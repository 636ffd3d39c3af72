"""Logging and metrics (port of agdiff_tpu/utils/logging.py): the logger
to the console and <log_dir>/log.txt, timestamped run directories, the
JSONL scalar stream (one {"step": n, name: value, ...} per line), the
same scalars as TensorBoard event files when the `tensorboard` package is
installed (the reference's train.py:152-158), and a writer that fans a
stream out to several."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


def get_logger(name: str, log_dir: Optional[str] = None) -> logging.Logger:
    """The logger `name`, to the console and to <log_dir>/log.txt: a file
    of an earlier call with another log_dir is closed, so that each run
    of a process writes its own directory's log only."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False  # no duplicate lines through the root logger
    formatter = logging.Formatter(
        "[%(asctime)s::%(name)s::%(levelname)s] %(message)s")
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        stream = logging.StreamHandler()
        stream.setFormatter(formatter)
        logger.addHandler(stream)
    path = os.path.abspath(os.path.join(log_dir, "log.txt")) if log_dir \
        else None
    for h in [h for h in logger.handlers
              if isinstance(h, logging.FileHandler)
              and h.baseFilename != path]:
        logger.removeHandler(h)
        h.close()
    if path and not any(isinstance(h, logging.FileHandler)
                        for h in logger.handlers):
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def get_new_log_dir(root: str = "./logs", prefix: str = "",
                    tag: str = "") -> str:
    """<root>/<prefix>_<YYYY_MM_DD__HH_MM_SS>[_<tag>], created."""
    name = time.strftime("%Y_%m_%d__%H_%M_%S", time.localtime())
    if prefix:
        name = prefix + "_" + name
    if tag:
        name = name + "_" + tag
    log_dir = os.path.join(root, name)
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


class MetricsWriter:
    """Append-only JSONL scalar stream; inactive without a path. A write
    after `close` reopens the file."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._f = open(path, "a")

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        if not self.path:
            return
        if self._f is None:
            self._f = open(self.path, "a")
        self._f.write(json.dumps({"step": step, **scalars}) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class TensorBoardWriter:
    """The scalar stream as TensorBoard event files in `log_dir`, through
    torch.utils.tensorboard, imported here and not at module level.
    Silently inactive (`active` False) without a log_dir or when that
    import fails, as the JAX package's writer is. A write after `close`
    starts a new event file in the same directory, as a resumed run
    does."""

    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self._summary_writer = None
        self._w = None
        if not log_dir:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._summary_writer = SummaryWriter
        self._w = SummaryWriter(log_dir)

    @property
    def active(self) -> bool:
        return self._summary_writer is not None

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        if not self.active:
            return
        if self._w is None:
            self._w = self._summary_writer(self.log_dir)
        for tag, value in scalars.items():
            self._w.add_scalar(tag, value, step)
        self._w.flush()

    def close(self) -> None:
        if self._w:
            self._w.close()
            self._w = None


class MultiWriter:
    """One scalar stream to several writers (the JSONL file and the
    TensorBoard events)."""

    def __init__(self, *writers):
        self.writers = [w for w in writers if w is not None]

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        for w in self.writers:
            w.write(step, scalars)

    def close(self) -> None:
        for w in self.writers:
            w.close()
