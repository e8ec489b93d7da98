"""ZeroMean.  Counterpart of ``gpytorch_tpu/means/zero_mean.py``: zeros of the inputs' batch
broadcast against ``batch_shape``, one a row, in the inputs' dtype and on their device."""

from __future__ import annotations

from typing import Sequence

import torch

from .mean import Mean


class ZeroMean(Mean):
    def __init__(self, batch_shape: Sequence[int] = ()):
        super().__init__()
        self.batch_shape = tuple(int(b) for b in batch_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = torch.broadcast_shapes(self.batch_shape, x.shape[:-2]) + x.shape[-2:-1]
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
