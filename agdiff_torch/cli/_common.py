"""Shared CLI plumbing (port of agdiff_tpu/cli/_common.py:58-104): a log
dir, checkpoint directory or reference .pt -> (config, module), and the
logger of utils/logging.py."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

from agdiff_torch.config import Config
from agdiff_torch.utils.logging import get_logger

__all__ = ["get_logger", "load_inference_bundle", "resolve_checkpoint"]


def resolve_checkpoint(ckpt: str, ckpt_iter: Optional[int] = None
                       ) -> Tuple[str, int]:
    """A log dir (its checkpoint `ckpt_iter`, or the latest) or a path
    (a checkpoint directory or a reference .pt, iteration 0) -> (path,
    iteration)."""
    from agdiff_torch.train.checkpoint import latest_checkpoint

    if os.path.isdir(os.path.join(ckpt, "checkpoints")):
        return latest_checkpoint(ckpt, ckpt_iter)
    return ckpt, 0


def load_inference_bundle(ckpt: str, ckpt_iter: Optional[int] = None,
                          dtype: Optional[str] = None, logger=None,
                          use_ema: bool = False):
    """A port log dir, a port checkpoint directory (train/checkpoint.py)
    or a reference .pt -> (Config, module in eval mode on the CPU,
    checkpoint path, iteration). The model config travels in the
    checkpoint (reference: scripts/test.py:111); `dtype` overrides its
    compute dtype, that of the module itself (its layers compute at it,
    models/dualenc.py) and of the fast engines built from the config
    (bf16 sampling of an f32-trained model, or an f32 teacher of a bf16
    one). use_ema samples
    with the EMA shadow's parameters and the raw running statistics, as
    the JAX CLI does. A log dir or checkpoint directory of the JAX
    package loads once convert_jax_checkpoint.py has converted it; an
    unconverted one raises, naming the converter (train/checkpoint.py)."""
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
    from agdiff_torch.models.reference_checkpoint import (
        load_reference_checkpoint,
    )
    from agdiff_torch.train.checkpoint import load_checkpoint

    path, it = resolve_checkpoint(ckpt, ckpt_iter)
    if path.endswith((".pt", ".pth")):
        if use_ema:
            raise ValueError("--ema is not available for reference .pt "
                             "checkpoints (no EMA shadow)")
        model, model_config = load_reference_checkpoint(path)
        config = Config(model=model_config)
        if logger:
            logger.info("imported reference torch checkpoint %s", path)
    elif os.path.isdir(path):
        state = load_checkpoint(path)
        config = state["config"]
        model = DualEncoderEpsNetwork(config.model)
        model.load_state_dict(state["module"])
        if use_ema:
            if state.get("ema") is None:
                raise ValueError(
                    f"--ema requested but {path} has no EMA shadow (train "
                    f"with train.ema_decay > 0)")
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(state["ema"][name])
            if logger:
                logger.info("sampling with the EMA weights")
        if logger:
            logger.info("loaded checkpoint %s (iteration %d)", path, it)
    else:
        raise FileNotFoundError(
            f"{ckpt}: neither a log dir, a checkpoint directory nor a "
            f"reference .pt")
    if dtype and dtype != config.model.dtype:
        config = dataclasses.replace(
            config, model=dataclasses.replace(config.model, dtype=dtype))
        state = model.state_dict()
        model = DualEncoderEpsNetwork(config.model)
        model.load_state_dict(state)
    return config, model.eval(), path, it
