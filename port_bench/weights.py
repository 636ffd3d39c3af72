"""Seeded weights, made on the device in one draw.

`make_weights(shapes, seed, device)` takes {name: shape} (the module's
parameter and buffer names) and returns {name: float32 tensor}: one
`torch.rand` of every element from a generator on `device` seeded with
`seed`, cut into the tensors in name order and scaled by role: a linear
layer's weight and bias uniform in +-1/sqrt(fan in) (PyTorch's default
scale), an embedding table of unit variance, a BatchNorm's affine near
(1, 0) and its running statistics near (0, 1), a softplus's beta near 1.
The same tensors go to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch


def _role(name: str, shape: Sequence[int]) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("running_mean", "running_var", "beta"):
        return leaf
    if "norm" in name:
        return "bn_" + leaf
    if "emb" in name:
        return "embedding"
    return "linear_" + leaf


def make_weights(shapes: Dict[str, Sequence[int]], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        u = flat[at:at + size].view(tuple(shapes[name]))
        at += size
        sym = 2.0 * u - 1.0
        role = _role(name, shapes[name])
        if role == "running_mean":
            t = 0.1 * sym
        elif role == "running_var":
            t = 1.0 + 0.5 * u
        elif role == "beta":
            t = 1.0 + 0.1 * sym
        elif role == "bn_weight":
            t = 1.0 + 0.1 * sym
        elif role == "bn_bias":
            t = 0.1 * sym
        elif role == "embedding":
            t = math.sqrt(3.0) * sym
        else:
            base = name.rsplit(".", 1)[0] + ".weight"
            fan_in = shapes[base][1] if len(shapes[base]) > 1 else 1
            t = sym / math.sqrt(fan_in)
        out[name] = t.contiguous()
    return out
