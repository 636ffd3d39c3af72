"""Logging and metrics (port of agdiff_tpu/utils/logging.py:15-66): the
logger to the console and <log_dir>/log.txt, timestamped run directories,
and the JSONL scalar stream (one {"step": n, name: value, ...} per line)."""

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
    """Append-only JSONL scalar stream."""

    def __init__(self, path: Optional[str]):
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._f = open(path, "a")

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps({"step": step, **scalars}) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
