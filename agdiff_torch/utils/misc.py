"""Misc utilities (port of agdiff_tpu/utils/misc.py:24)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_all(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (the port's
    own draws take explicit generators; this covers anything else)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
