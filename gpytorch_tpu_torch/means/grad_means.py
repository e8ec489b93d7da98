"""Means of derivative GPs, which pair with the grad kernels (``kernels/grad_kernels.py``):
(…, n, d + 1) outputs [m(x), ∇m(x)], or (…, n, 2d + 1) with the diagonal second derivatives
for ``RBFKernelGradGrad``.  Counterpart of ``gpytorch_tpu/means/grad_means.py``.

The constant means hold ``raw_constant`` of shape batch + (1,) (unconstrained, as in the JAX
package), the linear means ``weights`` (batch + (d, 1)) and ``bias`` (batch + (1,)).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .mean import Mean


def _constant_and_zeros(constant: torch.Tensor, x: torch.Tensor, batch_shape, width: int) -> torch.Tensor:
    """(…, n, width): the constant in column 0, zeros after it."""
    rows = torch.broadcast_shapes(batch_shape, x.shape[:-2]) + x.shape[-2:-1]
    first = constant.to(x.dtype).expand(rows).unsqueeze(-1)
    return torch.cat([first, torch.zeros(rows + (width - 1,), dtype=x.dtype, device=x.device)], -1)


class ConstantMeanGrad(Mean):
    """[c, 0, …, 0]: a constant value, and a zero gradient."""

    def __init__(self, batch_shape: Sequence[int] = ()):
        super().__init__()
        self.batch_shape = tuple(int(b) for b in batch_shape)
        self.register_parameter("raw_constant", torch.nn.Parameter(torch.zeros(self.batch_shape + (1,))))

    @property
    def constant(self) -> torch.Tensor:
        return self.raw_constant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _constant_and_zeros(self.raw_constant, x, self.batch_shape, x.shape[-1] + 1)


class ConstantMeanGradGrad(ConstantMeanGrad):
    """[c, 0, …, 0] over [f, ∇f, diag ∇²f]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _constant_and_zeros(self.raw_constant, x, self.batch_shape, 2 * x.shape[-1] + 1)


class LinearMeanGrad(Mean):
    """[x·w + b, w]: a linear value and its constant gradient."""

    def __init__(self, input_size: int, batch_shape: Sequence[int] = (), bias: bool = True):
        super().__init__()
        self.batch_shape = tuple(int(b) for b in batch_shape)
        self.register_parameter("weights", torch.nn.Parameter(torch.zeros(self.batch_shape + (int(input_size), 1))))
        self.has_bias = bool(bias)
        if self.has_bias:
            self.register_parameter("bias", torch.nn.Parameter(torch.zeros(self.batch_shape + (1,))))

    def _value_and_gradient(self, x: torch.Tensor):
        val = x @ self.weights  # (…, n, 1)
        if self.has_bias:
            val = val + self.bias.unsqueeze(-2)
        return val, self.weights[..., 0].unsqueeze(-2).expand(val.shape[:-1] + x.shape[-1:])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._value_and_gradient(x), -1)


class LinearMeanGradGrad(LinearMeanGrad):
    """[x·w + b, w, 0]: second derivatives zero."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        val, grad = self._value_and_gradient(x)
        return torch.cat([val, grad, torch.zeros_like(grad)], -1)
