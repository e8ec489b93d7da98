"""ToeplitzLinearOperator — a symmetric Toeplitz matrix held by its first column.

Counterpart of ``gpytorch_tpu/linop/toeplitz.py``: the covariance of a stationary kernel
on a regular 1D grid (``kernels/grid_kernel.py``).  Products through
``ops/toeplitz.py::sym_toeplitz_matmul`` (FFT), entries T[a, b] = c[|a − b|].  A column of
shape batch + (n,) holds one matrix per batch element (a batched kernel's grid).
"""

from __future__ import annotations

import torch

from ..ops.toeplitz import sym_toeplitz_matmul
from .base import LinearOperator


class ToeplitzLinearOperator(LinearOperator):
    def __init__(self, column: torch.Tensor):
        self.column = column

    def _shape(self):
        n = self.column.shape[-1]
        return tuple(self.column.shape[:-1]) + (n, n)

    @property
    def dtype(self):
        return self.column.dtype

    @property
    def device(self):
        return self.column.device

    def _matmul(self, rhs):
        return sym_toeplitz_matmul(self.column, rhs)

    def _flatten(self):
        return (self.column,), lambda ts: ToeplitzLinearOperator(ts[0])

    def _entries(self, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        return self.column[..., (rows - cols).abs()]

    def _diagonal(self):
        return self.column[..., :1].expand(self.column.shape)

    def to_dense(self):
        i = torch.arange(self.column.shape[-1], device=self.device)
        return self._entries(i.unsqueeze(-1), i)

    def _get_rows(self, idx):
        return self._entries(idx.unsqueeze(-1), torch.arange(self.column.shape[-1], device=self.device))
