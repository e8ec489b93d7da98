"""Triangular and Cholesky-factored operators: the dense-Cholesky branches of
``LinearOperator`` (N ≤ ``settings.max_cholesky_size``).

Counterpart of ``TriangularLinearOperator`` and ``CholLinearOperator`` in
``gpytorch_tpu/linop/triangular.py``, on ``torch.linalg.solve_triangular`` and
``torch.cholesky_solve`` (cuSOLVER and cuBLAS on a CUDA tensor; the JAX package computes
them with ``jax.scipy.linalg`` outside any Pallas kernel).  Both torch solves broadcast
the batch dimensions of the factor against those of the right-hand side, which the JAX
package's ``_bcast_solve_triangular`` and ``_bcast_cho_solve`` do by hand.  Their
log-determinants and inverse quadratic forms are closed forms at every size.
"""

from __future__ import annotations

import torch

from .base import ClosedFormInvQuadLogdet, LinearOperator


class TriangularLinearOperator(ClosedFormInvQuadLogdet, LinearOperator):
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

    def logdet(self) -> torch.Tensor:
        return torch.log(torch.abs(self._diagonal())).sum(-1)

    def _inv_quad_cols(self, rhs):
        return (rhs * self.solve(rhs)).sum(-2)


class CholLinearOperator(ClosedFormInvQuadLogdet, LinearOperator):
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

    def cholesky(self, upper: bool = False) -> TriangularLinearOperator:
        return TriangularLinearOperator(self.L.mT, upper=True) if upper else TriangularLinearOperator(self.L)

    def logdet(self) -> torch.Tensor:
        """2 Σ log |L_ii|: the determinant does not see the signs of L's columns, so an
        unconstrained variational factor whose diagonal turns negative is read right."""
        return 2.0 * torch.log(torch.abs(torch.diagonal(self.L, dim1=-2, dim2=-1)) + 1e-20).sum(-1)

    def _inv_quad_cols(self, rhs):
        return torch.linalg.solve_triangular(self.L, rhs, upper=False).square().sum(-2)

    def root_decomposition(self, method=None):
        from .root import RootLinearOperator

        return RootLinearOperator(self.L)

    def root_inv_decomposition(self, initial_vectors=None, method=None):
        """R = L⁻ᵀ: R Rᵀ = (L Lᵀ)⁻¹."""
        from .root import RootLinearOperator

        return RootLinearOperator(TriangularLinearOperator(self.L).inverse().tri.mT)
