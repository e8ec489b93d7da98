"""ZeroLinearOperator.  Counterpart of ``gpytorch_tpu/linop/zero.py``: the zero matrix of a
given shape, which a fixed noise returns for points it holds no noise for (a no-noise
prediction).  Added to another operator it leaves that operator as it is."""

from __future__ import annotations

import torch

from .base import LinearOperator, to_linear_operator


class ZeroLinearOperator(LinearOperator):
    def __init__(self, *shape, dtype: torch.dtype = torch.float32, device=None):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
            shape = tuple(shape[0])
        self._static_shape = tuple(int(s) for s in shape)
        self._dtype = dtype
        self._device = torch.device("cpu") if device is None else torch.device(device)

    def _shape(self):
        return self._static_shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device

    def _matmul(self, rhs):
        batch = torch.broadcast_shapes(self._static_shape[:-2], rhs.shape[:-2])
        return torch.zeros(batch + (self._static_shape[-2], rhs.shape[-1]), dtype=rhs.dtype, device=rhs.device)

    def to_dense(self):
        return torch.zeros(self._static_shape, dtype=self._dtype, device=self._device)

    def _diagonal(self):
        return torch.zeros(self._static_shape[:-2] + (min(self._static_shape[-2:]),), dtype=self._dtype,
                           device=self._device)

    def __add__(self, other):
        return to_linear_operator(other)
