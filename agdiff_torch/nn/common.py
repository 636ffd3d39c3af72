"""Shared building blocks (port of agdiff_tpu/nn/common.py).

Layers are `Linear`, a torch.nn.Linear (weight (out, in)); the weight
bridge (models/weights.py) transposes flax kernels (in, out) into them.

The compute dtype follows flax's `dtype` attribute: parameters stay
float32 (flax's `param_dtype`) and each `Linear` of `dtype` bfloat16
casts its input, weight and bias to bf16 before the product and the bias
add (agdiff_tpu/nn/common.py:40-52). `MaskedBatchNorm` and
`ShiftedSoftplus` take the dtype of their input, as in the JAX module. At
float32 every layer computes exactly what torch.nn.Linear does.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from agdiff_torch.ops import masked

LN2 = math.log(2.0)
LN2_BF16 = 0.69140625   # jnp.log(2.0).astype(bfloat16)


def shifted_softplus(x, beta):
    """softplus(beta * x) - ln 2. NOT F.softplus(x, beta=beta), which
    divides by beta."""
    return F.softplus(beta * x) - LN2


# jax.nn.gelu's constants as XLA holds them for a bf16 input
GELU_C_BF16 = 0.796875          # sqrt(2 / pi) rounded to bf16
GELU_CUBE_BF16 = 0.044677734375  # 0.044715 rounded to bf16


def gelu(x):
    """jax.nn.gelu's default, the tanh approximation. A bf16 input (the
    '-e16' engines' encoder) is evaluated as XLA evaluates it, rounded to
    bf16 after each operation, with bf16 constants; F.gelu would keep f32
    inside and round once."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    inner = GELU_C_BF16 * (x + GELU_CUBE_BF16 * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def activation_by_name(name: str):
    table = {"relu": torch.relu, "gelu": gelu}
    if name not in table:
        raise ValueError(f"Unknown activation: {name}")
    return table[name]


class Linear(nn.Linear):
    """torch.nn.Linear at a compute dtype: at float32 the plain layer; at
    bf16 x @ W^T rounded to bf16, then + b rounded again (the JAX layer's
    jnp.dot then its bias add), on bf16 casts of the f32 parameters, so
    that autograd takes the gradients back to them through the casts."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        plan = _TENSOR_PARALLEL[0]
        if plan is not None and self in plan:
            return parallel_linear(self, x, *plan[self])
        cd = self.compute_dtype
        if cd == torch.float32:
            return super().forward(x)
        y = torch.matmul(x.to(cd), self.weight.to(cd).t())
        return y if self.bias is None else y + self.bias.to(cd)


# the tensor-parallel plan inside tensor_parallel(): {Linear: (the dim of
# its weight that the layer's shard is cut from, the 'tp' Mesh)}
_TENSOR_PARALLEL = [None]


@contextlib.contextmanager
def tensor_parallel(plan):
    """Each Linear of `plan` (parallel/sharded.py, mode 'tp') holds one
    rank's shard of its weight and computes its share of the layer inside
    this context (parallel_linear); the others compute whole."""
    saved = _TENSOR_PARALLEL[0]
    _TENSOR_PARALLEL[0] = plan
    try:
        yield
    finally:
        _TENSOR_PARALLEL[0] = saved


def parallel_linear(layer: Linear, x, dim: int, mesh):
    """The layer on `x` (the same on every rank of `mesh`) from this rank's
    shard of its weight, at its compute dtype. dim 0, the output features
    (column-parallel): this rank's features, with its slice of the bias,
    then every rank's concatenated. dim 1, the input features
    (row-parallel): this rank's slice of x times the shard, the partial
    products summed over the ranks (in f32 at bf16, rounded once), then
    the bias. The
    collectives carry the gradients of a loss every rank computes alike
    (parallel/mesh.py: replicate, split, gather_replicated,
    sum_replicated)."""
    cd, w, b = layer.compute_dtype, layer.weight, layer.bias
    if dim == 0:
        b = None if b is None else mesh.split(b, 0)
        x = mesh.replicate(x)
        if cd == torch.float32:
            y = F.linear(x, w, b)
        else:
            y = torch.matmul(x.to(cd), w.to(cd).t())
            y = y if b is None else y + b.to(cd)
        return mesh.gather_replicated(y, -1)
    x = mesh.split(x, -1)
    if cd == torch.float32:
        y = mesh.sum_replicated(F.linear(x, w))
    else:
        # the bf16 operands' products summed in f32 and rounded once, as
        # the whole layer's bf16 product rounds its f32 sum once
        y = mesh.sum_replicated(torch.matmul(
            x.to(cd).float(), w.to(cd).float().t())).to(cd)
    return y if b is None else y + b.to(cd)


class ShiftedSoftplus(nn.Module):
    """softplus(beta * x) - ln 2 with a learnable scalar beta. On a bf16
    input, as the JAX module: the f32 beta promotes the product to f32,
    and ln 2 is rounded to bf16 first, so the output is f32."""

    def __init__(self):
        super().__init__()
        self.beta = nn.Parameter(torch.ones(()))

    def forward(self, x):
        if x.dtype == torch.float32:
            return shifted_softplus(x, self.beta)
        return F.softplus(self.beta * x.float()) - LN2_BF16


_FROZEN = [0]


# the data-parallel group whose ranks share train-mode statistics
_SYNCED = [None]


@contextlib.contextmanager
def synced_batch_stats(group):
    """Train-mode BatchNorm inside this context takes its statistics over
    every rank of the data-parallel `group` (parallel/mesh.py), the
    global batch's, and moves the running statistics alike on every
    rank; None leaves each process with its own block's. A step runs its
    forward and its backward inside it (a recomputation in backward
    needs the same statistics)."""
    saved = _SYNCED[0]
    _SYNCED[0] = group
    try:
        yield
    finally:
        _SYNCED[0] = saved


@contextlib.contextmanager
def frozen_running_stats():
    """Train-mode BatchNorm inside this context normalises with the batch
    statistics but leaves the running statistics alone: a recomputation
    in backward (torch.utils.checkpoint) must not update them a second
    time, as under flax's functional nn.remat."""
    _FROZEN[0] += 1
    try:
        yield
    finally:
        _FROZEN[0] -= 1


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the real nodes of a (B, N, C) block, zero on padded
    rows. `train` is passed explicitly, as in the JAX module (default
    False: the generation paths never touch the running statistics):
    train mode normalises with the f32 batch statistics over the whole
    block (biased variance) and moves the running statistics with momentum
    0.1 (unbiased variance, count / max(count - 1, 1)); eval mode uses the
    running statistics. The normalisation runs at the input's dtype, with
    the statistics and the affine cast to it (agdiff_tpu/nn/common.py:
    120-125). Under `synced_batch_stats(group)` the batch statistics are
    the data-parallel group's."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, mask, train: bool = False):
        if train:
            mean, var, count = masked.masked_batch_norm_stats(
                x.float(), mask, group=_SYNCED[0])
            if not _FROZEN[0]:
                with torch.no_grad():
                    # (1 - m) * old + m * new, as a lerp: fewer launches
                    unbiased = var * (count / torch.clamp(count - 1.0,
                                                          min=1.0))
                    self.running_mean.lerp_(mean, self.momentum)
                    self.running_var.lerp_(unbiased, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        dt = x.dtype
        y = (x - mean.to(dt)) * (inv * self.weight).to(dt) + self.bias.to(dt)
        return torch.where(mask[..., None], y, torch.zeros_like(y))
