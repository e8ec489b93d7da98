"""Mean base class.  Counterpart of ``gpytorch_tpu/means/mean.py``: a module whose call takes
inputs (…, n, d), or (n,) read as one input dimension."""

from __future__ import annotations

import torch

from ..core.module import Module


class Mean(Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return super().__call__(x.unsqueeze(-1) if x.ndim == 1 else x, **kwargs)
