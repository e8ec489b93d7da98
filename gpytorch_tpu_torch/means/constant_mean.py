"""ConstantMean.  Counterpart of ``gpytorch_tpu/means/constant_mean.py``: one constant, or
one per batch element (``raw_constant`` of shape ``batch_shape``)."""

from __future__ import annotations

import torch

from ..core.module import Module


class ConstantMean(Module):
    def __init__(self, constant_prior=None, batch_shape=()):
        super().__init__()
        self.batch_shape = tuple(int(b) for b in batch_shape)
        self.register_parameter("raw_constant", torch.nn.Parameter(torch.zeros(self.batch_shape)))
        if constant_prior is not None:
            # the JAX package's (and GPyTorch's) name for this prior
            self.register_prior("mean_prior", constant_prior, lambda m: m.constant,
                                lambda m, v: m._set_constrained("raw_constant", v))

    @property
    def constant(self) -> torch.Tensor:
        return self.raw_constant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.unsqueeze(-1) if x.ndim == 1 else x
        shape = torch.broadcast_shapes(self.batch_shape, x.shape[:-2]) + x.shape[-2:-1]
        return self.constant.to(x.dtype).unsqueeze(-1).expand(shape)
