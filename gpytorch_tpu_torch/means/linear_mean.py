"""LinearMean: m(x) = x·w + b.  Counterpart of ``gpytorch_tpu/means/linear_mean.py``: weights
of shape batch + (d, 1) and a bias of shape batch + (1,), one per batch element (the
hidden layer of a deep GP has one per output dimension)."""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.module import Module


class LinearMean(Module):
    def __init__(self, input_size: int, batch_shape: Sequence[int] = (), bias: bool = True):
        super().__init__()
        self.batch_shape = tuple(int(b) for b in batch_shape)
        self.register_parameter("weights", torch.nn.Parameter(torch.zeros(self.batch_shape + (int(input_size), 1))))
        self.has_bias = bool(bias)
        if self.has_bias:
            self.register_parameter("bias", torch.nn.Parameter(torch.zeros(self.batch_shape + (1,))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = (x @ self.weights).squeeze(-1)
        return res + self.bias if self.has_bias else res
