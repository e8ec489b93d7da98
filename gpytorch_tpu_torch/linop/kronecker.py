"""Kronecker-product operators.

Counterpart of ``gpytorch_tpu/linop/kronecker.py``: ``KroneckerProductLinearOperator``
A₁ ⊗ … ⊗ A_p (the covariance of a stationary kernel on a Cartesian grid,
``kernels/grid_kernel.py``, whose factors are per-dimension Toeplitz operators),
``KroneckerProductDiagLinearOperator`` (a product of diagonal factors, itself diagonal),
and ``KroneckerProductAddedDiagLinearOperator`` (⊗ᵢ Kᵢ) + σ²I, solved in closed form from
the factors' eigendecompositions (a diagonal factor, such as the identity of the multitask
noise I_n ⊗ Σ_task, takes its trivial one).  The first factor varies slowest.  Batched
factors take the JAX package's dense fallback (``gpytorch_tpu/linop/kronecker.py:56-66,
105-107, 232-234``): products with the formed matrix, and solves by CG.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .base import LinearOperator, ProbeSource, to_linear_operator
from .diag import DiagLinearOperator


def _kron_matmul(factors: Sequence, rhs: torch.Tensor) -> torch.Tensor:
    """(A₁ ⊗ … ⊗ A_p)·rhs by contracting one factor at a time on rhs reshaped to
    (n₁, …, n_p, k), without forming the product.  Factors are operators or tensors."""
    dense = [f.to_dense() if isinstance(f, LinearOperator) else f for f in factors]
    k = rhs.shape[-1]
    x = rhs.reshape(*[f.shape[-1] for f in dense], k)
    for i, f in enumerate(dense):
        x = torch.tensordot(f, x.movedim(i, 0), dims=([1], [0])).movedim(0, i)
    return x.reshape(math.prod(f.shape[-2] for f in dense), k)


def _batched_kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ⊗ b over the last two dims, broadcasting the batch dims."""
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    (n1, m1), (n2, m2) = a.shape[-2:], b.shape[-2:]
    prod = a[..., :, None, :, None] * b[..., None, :, None, :]
    return prod.reshape(tuple(batch) + (n1 * n2, m1 * m2))


def _split_index(index: torch.Tensor, sizes: Sequence[int]):
    """The per-factor indices of a flat index, the last factor fastest."""
    parts = []
    for size in reversed(sizes):
        parts.append(index % size)
        index = torch.div(index, size, rounding_mode="floor")
    return parts[::-1]


def _solve_squeezed(fn, rhs: torch.Tensor) -> torch.Tensor:
    if rhs.ndim == 1:
        return fn(rhs.unsqueeze(-1)).squeeze(-1)
    return fn(rhs)


def _closed_form_inv_quad_logdet(op, inv_quad_rhs, logdet, reduce_inv_quad, solver_state, return_state):
    """(rhsᵀ op⁻¹ rhs, log|op|) from the operator's own ``solve`` and ``logdet``; a warm
    start's state passes through untouched, as in the JAX package."""
    ld = op.logdet() if logdet else None
    iq = None
    if inv_quad_rhs is not None:
        rhs = inv_quad_rhs if inv_quad_rhs.ndim > 1 else inv_quad_rhs.unsqueeze(-1)
        iq = (rhs * op.solve(rhs)).sum(-2)
        if reduce_inv_quad:
            iq = iq.sum(-1)
    return ((iq, ld), solver_state) if return_state else (iq, ld)


class KroneckerProductLinearOperator(LinearOperator):
    def __init__(self, *factors):
        self.factors = tuple(to_linear_operator(f) for f in factors)

    def _shape(self):
        batch = torch.broadcast_shapes(*[f.batch_shape for f in self.factors])
        return tuple(batch) + (math.prod(f.shape[-2] for f in self.factors),
                               math.prod(f.shape[-1] for f in self.factors))

    @property
    def dtype(self):
        return self.factors[0].dtype

    @property
    def device(self):
        return self.factors[0].device

    def _has_batched_factors(self) -> bool:
        return any(len(f.shape) > 2 for f in self.factors)

    def _matmul(self, rhs):
        if self._has_batched_factors() or rhs.ndim > 2:
            return self.to_dense() @ rhs
        return _kron_matmul(self.factors, rhs)

    def _flatten(self):
        parts = [f._flatten() for f in self.factors]
        counts = [len(ts) for ts, _ in parts]

        def rebuild(tensors):
            out, start = [], 0
            for (_, rb), c in zip(parts, counts):
                out.append(rb(tensors[start:start + c]))
                start += c
            return type(self)(*out)

        return tuple(t for ts, _ in parts for t in ts), rebuild

    def _entries(self, rows, cols):
        sizes = [f.shape[-1] for f in self.factors]
        out = None
        for f, r, c in zip(self.factors, _split_index(rows, sizes), _split_index(cols, sizes)):
            e = f._entries(r, c)
            out = e if out is None else out * e
        return out

    def _diagonal(self):
        out = self.factors[0]._diagonal()
        for f in self.factors[1:]:
            out = (out.unsqueeze(-1) * f._diagonal().unsqueeze(-2)).flatten(-2)
        return out

    def to_dense(self):
        out = self.factors[0].to_dense()
        for f in self.factors[1:]:
            out = torch.kron(out, f.to_dense()) if out.ndim == 2 and len(f.shape) == 2 else _batched_kron(out, f.to_dense())
        return out

    def _get_rows(self, idx):
        n = self.shape[-1]
        return self._entries(idx.unsqueeze(-1), torch.arange(n, device=idx.device))

    def logdet(self):
        """Σᵢ (N / nᵢ) log|Aᵢ|."""
        n = self.shape[-1]
        out = None
        for f in self.factors:
            term = f.logdet() * (n / f.shape[-1])
            out = term if out is None else out + term
        return out

    def solve(self, rhs):
        """(⊗ᵢ Aᵢ)⁻¹ = ⊗ᵢ Aᵢ⁻¹, each factor inverted through its Cholesky factor."""
        from ..solvers.cholesky import psd_safe_cholesky

        if self._has_batched_factors():
            return super().solve(rhs)
        inverses = []
        for f in self.factors:
            fd = f.to_dense()
            eye = torch.eye(fd.shape[-1], dtype=fd.dtype, device=fd.device)
            inverses.append(torch.cholesky_solve(eye, psd_safe_cholesky(fd)))
        return _solve_squeezed(lambda r: _kron_matmul(inverses, r), rhs)

    def inv_quad_logdet(self, inv_quad_rhs=None, logdet=False, reduce_inv_quad=True, base_samples: ProbeSource = None,
                        solver_state=None, return_state=False):
        return _closed_form_inv_quad_logdet(self, inv_quad_rhs, logdet, reduce_inv_quad, solver_state, return_state)

    def add_diagonal(self, diag):
        """+ σ²I with a constant σ² (a scalar, or one of shape batch + (1,)) stays a
        ``KroneckerProductAddedDiagLinearOperator``."""
        diag = torch.as_tensor(diag, dtype=self.dtype, device=self.device)
        if diag.numel() == 1:
            return KroneckerProductAddedDiagLinearOperator(self, diag.reshape(1))
        if diag.shape[-1] == 1:
            return KroneckerProductAddedDiagLinearOperator(self, diag)
        return super().add_diagonal(diag)


class KroneckerProductDiagLinearOperator(KroneckerProductLinearOperator):
    """A Kronecker product of diagonal operators: diagonal, with closed forms."""

    def __init__(self, *factors: DiagLinearOperator):
        self.factors = tuple(factors)

    @property
    def diag(self) -> torch.Tensor:
        return KroneckerProductLinearOperator._diagonal(self)

    def _diag_values(self):
        return self.diag

    def _eig_lower_bound(self):
        return self.diag.min()

    def _matmul(self, rhs):
        return self.diag.unsqueeze(-1) * rhs

    def _diagonal(self):
        return self.diag

    def to_dense(self):
        return torch.diag_embed(self.diag)

    def logdet(self):
        return torch.log(self.diag).sum(-1)

    def solve(self, rhs):
        return _solve_squeezed(lambda r: r / self.diag.unsqueeze(-1), rhs)


class KroneckerProductAddedDiagLinearOperator(LinearOperator):
    """(⊗ᵢ Kᵢ) + σ²I with a constant σ² (shape batch + (1,)): with Kᵢ = Qᵢ Λᵢ Qᵢᵀ,
    (K + σ²I)⁻¹ = (⊗Qᵢ)(Λ + σ²I)⁻¹(⊗Qᵢ)ᵀ and log|K + σ²I| = Σ log(λ + σ²)."""

    def __init__(self, kron: KroneckerProductLinearOperator, const_diag: torch.Tensor):
        self.kron = kron
        self.const_diag = const_diag

    @property
    def dtype(self):
        return self.kron.dtype

    @property
    def device(self):
        return self.kron.device

    def _shape(self):
        return tuple(torch.broadcast_shapes(self.kron.shape, tuple(self.const_diag.shape[:-1]) + (1, 1)))

    def _const(self) -> torch.Tensor:
        """σ² broadcastable against (..., n, k)."""
        return self.const_diag if self.const_diag.ndim == 1 else self.const_diag.unsqueeze(-1)

    def _matmul(self, rhs):
        return self.kron._matmul(rhs) + self._const() * rhs

    def _flatten(self):
        tk, rk = self.kron._flatten()
        nk = len(tk)
        return tk + (self.const_diag,), lambda ts: KroneckerProductAddedDiagLinearOperator(rk(ts[:nk]), ts[nk])

    def _diagonal(self):
        return self.kron._diagonal() + self.const_diag

    def to_dense(self):
        n = self.shape[-1]
        return self.kron.to_dense() + self._const() * torch.eye(n, dtype=self.dtype, device=self.device)

    def _eigs(self):
        qs, lam_full = [], None
        for f in self.kron.factors:
            if isinstance(f, DiagLinearOperator):
                lam = f._diag_values()
                q = torch.eye(f.shape[-1], dtype=lam.dtype, device=lam.device)
            else:
                lam, q = torch.linalg.eigh(f.to_dense())
            qs.append(q)
            lam_full = lam if lam_full is None else (lam_full.unsqueeze(-1) * lam.unsqueeze(-2)).flatten(-2)
        return qs, lam_full

    def logdet(self):
        _, lam = self._eigs()
        return torch.log(lam + self.const_diag).sum(-1)

    def solve(self, rhs):
        if self.kron._has_batched_factors() or self.const_diag.ndim > 1:
            return LinearOperator.solve(self, rhs)
        qs, lam = self._eigs()

        def fn(r):
            tmp = _kron_matmul([q.mT for q in qs], r) / (lam + self.const_diag).unsqueeze(-1)
            return _kron_matmul(qs, tmp)

        return _solve_squeezed(fn, rhs)

    def inv_quad_logdet(self, inv_quad_rhs=None, logdet=False, reduce_inv_quad=True, base_samples: ProbeSource = None,
                        solver_state=None, return_state=False):
        return _closed_form_inv_quad_logdet(self, inv_quad_rhs, logdet, reduce_inv_quad, solver_state, return_state)

    def add_diagonal(self, diag):
        diag = torch.as_tensor(diag, dtype=self.dtype, device=self.device)
        if diag.numel() == 1:
            return KroneckerProductAddedDiagLinearOperator(self.kron, self.const_diag + diag.reshape(1))
        if diag.shape[-1] == 1:
            return KroneckerProductAddedDiagLinearOperator(self.kron, self.const_diag + diag)
        return super().add_diagonal(diag)
