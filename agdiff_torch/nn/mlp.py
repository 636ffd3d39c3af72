"""Dense MLP (port of agdiff_tpu/nn/mlp.py): activation between layers,
never after the last; dropout after the activation in train mode only.
`dtype` is every layer's compute dtype (nn/common.py::Linear)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from agdiff_torch.nn.common import Linear, activation_by_name


class MultiLayerPerceptron(nn.Module):
    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 activation: str = "relu", dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = activation_by_name(activation)
        self.dropout = dropout
        self.num_layers = len(hidden_dims)
        for i, dim in enumerate(hidden_dims):
            self.add_module(f"layers_{i}", Linear(in_dim, dim, dtype=dtype))
            in_dim = dim

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = self.act(x)
                if train and self.dropout > 0.0:
                    keep = 1.0 - self.dropout
                    u = torch.rand(x.shape, generator=generator,
                                   device=x.device)
                    x = torch.where(u < keep, x / keep, torch.zeros_like(x))
        return x
