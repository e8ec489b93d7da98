"""Diagonal operators.  Counterpart of ``gpytorch_tpu/linop/diag.py``."""

from __future__ import annotations

import torch

from .base import LinearOperator


class DiagLinearOperator(LinearOperator):
    """diag(d) with d of shape (n,)."""

    def __init__(self, diag: torch.Tensor):
        self.diag = diag

    def _diag_values(self) -> torch.Tensor:
        return self.diag

    def _eig_lower_bound(self) -> torch.Tensor:
        return self.diag.min()  # the eigenvalues are the diagonal

    def _shape(self):
        n = self.diag.shape[-1]
        return (n, n)

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device

    def _matmul(self, rhs):
        return self.diag.unsqueeze(-1) * rhs

    def _diagonal(self):
        return self.diag

    def to_dense(self):
        return torch.diag_embed(self.diag)

    def _get_rows(self, idx):
        rows = torch.zeros(idx.shape[0], self.shape[-1], dtype=self.dtype, device=self.device)
        rows[torch.arange(idx.shape[0], device=self.device), idx] = self.diag[idx]
        return rows

    def add_diagonal(self, diag):
        return DiagLinearOperator(self.diag + diag)

    def _flatten(self):
        return (self.diag,), lambda ts: DiagLinearOperator(ts[0])

    def __add__(self, other):
        if isinstance(other, DiagLinearOperator):
            return DiagLinearOperator(self.diag + other._diag_values())
        if isinstance(other, LinearOperator):
            return other.add_diagonal(self.diag)
        return super().__add__(other)


class ConstantDiagLinearOperator(DiagLinearOperator):
    """c·I of size n, with c of shape (1,)."""

    def __init__(self, value: torch.Tensor, diag_shape: int):
        self.value = value
        self._diag_shape = int(diag_shape)

    @property
    def diag(self) -> torch.Tensor:
        return self.value.expand(self._diag_shape)

    def _eig_lower_bound(self) -> torch.Tensor:
        return self.value[0]

    def _matmul(self, rhs):
        return self.value * rhs

    def _flatten(self):
        n = self._diag_shape
        return (self.value,), lambda ts: ConstantDiagLinearOperator(ts[0], n)
