"""Weights for the port's modules.

`load_jax_variables` is the bridge from a trained JAX model: it takes the
flax `{"params", "batch_stats"}` tree as nested dicts of numpy arrays and
sets every parameter and buffer of a module whose names follow the flax
scopes (models/dualenc.py); `export_jax_variables` is its inverse, so
weights cross in both directions. `init_random` makes seeded random
weights for runs without a checkpoint (chip_smoke.py's and the stamps'
models depend on its draws); `init_like_jax` draws a model to train from
the distributions of the JAX package's `init_model`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from agdiff_torch.nn.common import MaskedBatchNorm
from agdiff_torch.nn.schnet import CFConv

# flax leaf name -> torch attribute name, per collection
_LEAF = {
    "params": {"kernel": "weight", "bias": "bias", "embedding": "weight",
               "scale": "weight", "beta": "beta"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}


def _leaves(tree: Dict[str, Any], prefix=()) -> Iterator[Tuple[tuple, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_jax_variables(module: nn.Module, variables: Dict[str, Any]) -> None:
    """Copy a JAX variables tree into `module`, strictly: every JAX leaf
    must land on a parameter or buffer of matching shape, and every
    parameter and buffer must be set. Flax kernels (in, out) become torch
    weights (out, in)."""
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    unset = set(targets)
    for collection, tree in variables.items():
        names = _LEAF.get(collection)
        if names is None:
            raise KeyError(f"unknown variable collection {collection!r}")
        for path, value in _leaves(tree):
            if path[-1] not in names:
                raise KeyError(f"unmapped JAX leaf {collection}/"
                               + "/".join(path))
            key = ".".join(path[:-1] + (names[path[-1]],))
            if key not in targets:
                raise KeyError(f"JAX leaf {collection}/{'/'.join(path)} has "
                               f"no port counterpart {key!r}")
            arr = np.asarray(value, np.float32)
            if path[-1] == "kernel":
                arr = arr.T
            dst = targets[key]
            if tuple(dst.shape) != arr.shape:
                raise ValueError(f"{key}: shape {tuple(dst.shape)} != "
                                 f"{arr.shape}")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.array(arr, order="C")))
            unset.discard(key)
    if unset:
        raise KeyError(f"port parameters not set by the JAX tree: "
                       f"{sorted(unset)}")


def init_random(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights: torch-default uniform(+-1/sqrt(fan_in)) for
    Linear layers, N(0, 1) embeddings, unit learnable betas, identity
    BatchNorm statistics."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, nn.Linear):
                bound = 1.0 / math.sqrt(sub.in_features)
                sub.weight.uniform_(-bound, bound, generator=gen)
                if sub.bias is not None:
                    sub.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(sub, nn.Embedding):
                sub.weight.normal_(0.0, 1.0, generator=gen)
    return module


def init_like_jax(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Weights drawn as `agdiff_tpu.models.dualenc.init_model` draws them:
    Linear weights and biases U(+-1/sqrt(fan_in)) (agdiff_tpu/nn/common.py:
    14-28), but xavier-uniform weights and zero biases for every CFConv's
    filter_0, filter_1, lin1 and lin2 (agdiff_tpu/nn/schnet.py:78-92, 113),
    N(0, 1) embeddings, unit BatchNorm scales and learnable betas, zero
    BatchNorm biases, and running statistics 0 and 1. The draws come from
    `generator` (a CPU generator) in module order."""
    xavier = {id(getattr(sub, name)) for sub in module.modules()
              if isinstance(sub, CFConv)
              for name in ("filter_0", "filter_1", "lin1", "lin2")}
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, nn.Linear):
                w = torch.empty(sub.weight.shape)
                if id(sub) in xavier:
                    fan_out, fan_in = sub.weight.shape
                    bound = math.sqrt(6.0 / (fan_in + fan_out))
                    w.uniform_(-bound, bound, generator=generator)
                    b = torch.zeros(sub.out_features)
                else:
                    bound = 1.0 / math.sqrt(sub.in_features)
                    w.uniform_(-bound, bound, generator=generator)
                    b = (None if sub.bias is None else
                         torch.empty(sub.out_features).uniform_(
                             -bound, bound, generator=generator))
                sub.weight.copy_(w)
                if sub.bias is not None:
                    sub.bias.copy_(b)
            elif isinstance(sub, nn.Embedding):
                sub.weight.copy_(torch.empty(sub.weight.shape).normal_(
                    0.0, 1.0, generator=generator))
            elif isinstance(sub, MaskedBatchNorm):
                sub.weight.fill_(1.0)
                sub.bias.fill_(0.0)
                sub.running_mean.fill_(0.0)
                sub.running_var.fill_(1.0)
        for name, p in module.named_parameters():
            if name.endswith("beta"):
                p.fill_(1.0)
    return module


def flax_leaf(module: nn.Module, name: str) -> Tuple[str, tuple]:
    """(collection, flax path) of a parameter or buffer name of the port:
    the inverse of load_jax_variables' naming."""
    *scope, leaf = name.split(".")
    owner = module.get_submodule(".".join(scope)) if scope else module
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", tuple(scope) + (leaf[len("running_"):],)
    if leaf == "weight":
        if isinstance(owner, nn.Linear):
            leaf = "kernel"
        elif isinstance(owner, nn.Embedding):
            leaf = "embedding"
        elif isinstance(owner, MaskedBatchNorm):
            leaf = "scale"
        else:
            raise KeyError(f"no flax name for {name!r}")
    elif leaf not in ("bias", "beta"):
        raise KeyError(f"no flax name for {name!r}")
    return "params", tuple(scope) + (leaf,)


def export_jax_variables(module: nn.Module) -> Dict[str, Any]:
    """The flax-named {"params", "batch_stats"} tree of a port module as
    float32 numpy arrays (torch weights (out, in) become kernels (in,
    out)): load_jax_variables' inverse, and what the JAX package's
    `model.apply` takes."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    tensors = list(module.named_parameters()) + list(module.named_buffers())
    for name, t in tensors:
        collection, path = flax_leaf(module, name)
        arr = t.detach().cpu().float().numpy()
        if path[-1] == "kernel":
            arr = arr.T
        node = out[collection]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(arr, order="C")
    return out
