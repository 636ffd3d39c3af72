"""Shared CLI plumbing (port of agdiff_tpu/cli/_common.py:58-104 and of
agdiff_tpu/utils/logging.py::get_logger): a reference .pt checkpoint ->
(config, module), and a logger to the console and <log_dir>/log.txt."""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

from agdiff_torch.config import Config


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


def load_inference_bundle(ckpt: str, dtype: Optional[str] = None,
                          logger=None):
    """A reference .pt checkpoint -> (Config, module in eval mode on the
    CPU). The model config travels in the checkpoint (reference:
    scripts/test.py:111); `dtype` overrides its compute dtype (bf16
    sampling of an f32-trained model). The JAX package's own checkpoint
    directories (orbax) and the EMA shadow are not read by the port
    (ROADMAP.md, queue 1)."""
    from agdiff_torch.models.reference_checkpoint import (
        load_reference_checkpoint,
    )

    if not ckpt.endswith((".pt", ".pth")):
        raise NotImplementedError(
            f"{ckpt}: the port reads reference .pt checkpoints; the JAX "
            f"package's checkpoint directories wait for the port of its "
            f"checkpoint module (ROADMAP.md, queue 1)")
    model, model_config = load_reference_checkpoint(ckpt)
    if logger:
        logger.info("imported reference torch checkpoint %s", ckpt)
    if dtype:
        model_config = dataclasses.replace(model_config, dtype=dtype)
        model.config = model_config
    return Config(model=model_config), model
