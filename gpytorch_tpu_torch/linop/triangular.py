"""Triangular and Cholesky-factored operators: the dense-Cholesky branches of
``LinearOperator`` (N ≤ ``settings.max_cholesky_size``).

Counterpart of ``TriangularLinearOperator`` and ``CholLinearOperator`` in
``gpytorch_tpu/linop/triangular.py``, on ``torch.linalg.solve_triangular`` and
``torch.cholesky_solve`` (cuSOLVER and cuBLAS on a CUDA tensor; the JAX package computes
them with ``jax.scipy.linalg`` outside any Pallas kernel).
"""

from __future__ import annotations

import torch

from .base import LinearOperator


class TriangularLinearOperator(LinearOperator):
    """A lower (or, with ``upper``, upper) triangular matrix."""

    def __init__(self, tri: torch.Tensor, upper: bool = False):
        self.tri = tri
        self.upper = bool(upper)

    def _shape(self):
        return self.tri.shape

    @property
    def dtype(self):
        return self.tri.dtype

    @property
    def device(self):
        return self.tri.device

    def _matmul(self, rhs):
        return self.tri @ rhs

    def _diagonal(self):
        return torch.diagonal(self.tri, dim1=-2, dim2=-1)

    def to_dense(self):
        return self.tri

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        squeeze = rhs.ndim == 1
        rhs = rhs.unsqueeze(-1) if squeeze else rhs
        res = torch.linalg.solve_triangular(self.tri, rhs, upper=self.upper)
        return res.squeeze(-1) if squeeze else res

    def inverse(self) -> "TriangularLinearOperator":
        eye = torch.eye(self.tri.shape[-1], dtype=self.dtype, device=self.device)
        return TriangularLinearOperator(torch.linalg.solve_triangular(self.tri, eye, upper=self.upper), self.upper)


class CholLinearOperator(LinearOperator):
    """A = L Lᵀ from its lower Cholesky factor L."""

    def __init__(self, chol: torch.Tensor):
        self.L = chol

    def _shape(self):
        return self.L.shape

    @property
    def dtype(self):
        return self.L.dtype

    @property
    def device(self):
        return self.L.device

    def _matmul(self, rhs):
        return self.L @ (self.L.mT @ rhs)

    def _diagonal(self):
        return (self.L * self.L).sum(-1)

    def to_dense(self):
        return self.L @ self.L.mT

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        squeeze = rhs.ndim == 1
        rhs = rhs.unsqueeze(-1) if squeeze else rhs
        res = torch.cholesky_solve(rhs, self.L)
        return res.squeeze(-1) if squeeze else res

    def root_decomposition(self, method=None):
        from .root import RootLinearOperator

        return RootLinearOperator(self.L)

    def root_inv_decomposition(self, initial_vectors=None, method=None):
        """R = L⁻ᵀ: R Rᵀ = (L Lᵀ)⁻¹."""
        from .root import RootLinearOperator

        return RootLinearOperator(TriangularLinearOperator(self.L).inverse().tri.mT)
