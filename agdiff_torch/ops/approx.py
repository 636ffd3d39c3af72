"""Polynomial and rational stand-ins for the hot transcendentals (port of
agdiff_tpu/ops/approx.py, same coefficients).

The `-approx` engines (models/fast_forward.py) use them in the edge
encoder (gelu), the distance weights (sigmoid) and inside K1 (softplus,
sigmoid; csrc/stack_packed.cu holds the same formulas in f32). Max abs
error over the real line: softplus 1.9e-4, sigmoid 6.8e-4, tanh 1.4e-3,
gelu 2.5e-3 against the erf gelu; all below bf16's resolution. bf16 inputs
are evaluated in f32 and rounded back.
"""

from __future__ import annotations

import torch

# degree-8 fit of log1p(exp(-t)) on t in [0, 8], power basis, ascending
SOFTPLUS_TAIL = (
    6.93209096e-01, -5.00341100e-01, 1.24495898e-01, 3.08196131e-03,
    -9.28887060e-03, 2.42865434e-03, -3.09991317e-04, 2.03902123e-05,
    -5.52531068e-07,
)
GELU_C = 0.7978845608028654  # sqrt(2 / pi)


def _f32(x):
    return x.float() if x.dtype == torch.bfloat16 else x


def softplus(x):
    """max(x, 0) + poly(min(|x|, 8)), about log1p(exp(x))."""
    x32 = _f32(x)
    t = torch.clamp(x32.abs(), max=8.0)
    acc = torch.full_like(t, SOFTPLUS_TAIL[-1])
    for c in SOFTPLUS_TAIL[-2::-1]:
        acc = acc * t + c
    return (torch.clamp(x32, min=0.0) + acc).to(x.dtype)


def tanh(x):
    """Odd Pade [5/4] tanh, clamped."""
    x32 = _f32(x)
    y = torch.clamp(x32, -4.0, 4.0)
    y2 = y * y
    r = y * (945.0 + 105.0 * y2 + y2 * y2) / (
        945.0 + 420.0 * y2 + 15.0 * y2 * y2)
    return torch.clamp(r, -1.0, 1.0).to(x.dtype)


def sigmoid(x):
    """0.5 * (1 + tanh(x / 2)) with the rational tanh."""
    return (0.5 * (1.0 + tanh(x * 0.5))).to(x.dtype)


def gelu(x):
    """tanh-form gelu with the rational tanh."""
    x32 = _f32(x)
    inner = GELU_C * (x32 + 0.044715 * x32 * x32 * x32)
    return (0.5 * x32 * (1.0 + tanh(inner))).to(x.dtype)


def relu(x):
    """Exact; here so that activation tables can map every name."""
    return torch.clamp(x, min=0)
