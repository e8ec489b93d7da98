"""K + D — the operator that preconditioned CG solves.

Counterpart of ``gpytorch_tpu/linop/added_diag.py``.  The preconditioner is the pivoted
Cholesky factor L (P = LLᵀ + D), τ-regularised under ``preconditioner_noise_budget`` and
applied in the whitened eigenbasis; log|P| comes from a Cholesky factor and is
differentiable, for the variance-reduced log-determinant gradient of training.  A batched
operator gets one preconditioner per batch element: its own pivots, τ and factor.
"""

from __future__ import annotations

import torch

from .. import settings
from .base import LinearOperator
from .diag import DiagLinearOperator


def _gram(a: torch.Tensor) -> torch.Tensor:
    """aᵀa of a factor a (*batch, n, k), one matrix product per batch element, so that an
    element of a batch gets the preconditioner it would get alone.  A batched GEMM sums an
    element's n rows otherwise than the unbatched one: on phase 13's factors (N=100,000,
    k=50, an H100) the two read 4e-5 of |aᵀa| apart, which CG run past its tolerance
    amplified to 7e-3 of one element's MLL, where the unbatched product stayed within
    3e-6 of float64."""
    if a.ndim == 2:
        return a.mT @ a
    flat = a.reshape((-1,) + a.shape[-2:])
    return torch.stack([f.mT @ f for f in flat]).reshape(a.shape[:-2] + (a.shape[-1], a.shape[-1]))


class _PCFastGrad(torch.autograd.Function):
    """The pivoted-Cholesky root with the gradient of its fixed-pivot Nyström form
    (``settings.fast_precond_grad``; ``gpytorch_tpu/linop/added_diag.py::_pc_fast_grad``).

    Its value is the pivoted-Cholesky factor, so callers that only read it (CG
    preconditioning, probe draws) pay nothing extra.  Its gradient is that of
    K[:, p] K[p, p]⁻¹ K[p, :]'s root on the same pivots p — the same function of the
    hyperparameters for a fixed pivot order — which costs one k×k Cholesky and one
    triangular solve instead of a backward through the k-step loop.  The operator comes
    in as its flattened tensors (``LinearOperator._flatten``)."""

    @staticmethod
    def forward(ctx, rebuild, rank, rel_tol, *tensors):
        from ..solvers.pivoted_cholesky import pivoted_cholesky

        L, piv = pivoted_cholesky(rebuild(tensors), rank=rank, rel_tol=rel_tol, return_pivots=True)
        # columns the loop zeroed (exhausted residual) carry no value and no gradient
        col_live = ((L * L).sum(-2, keepdim=True) > 0.0).to(L.dtype)
        ctx.rebuild = rebuild
        ctx.save_for_backward(piv, col_live, *tensors)
        ctx.mark_non_differentiable(piv)
        return L, piv

    @staticmethod
    def backward(ctx, g, _):
        from ..solvers.pivoted_cholesky import nystrom_factor_from_pivots

        piv, col_live, *tensors = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip(tensors, needs)]
            L = nystrom_factor_from_pivots(ctx.rebuild(leaves), piv) * col_live
            wrt = [leaf for leaf in leaves if leaf.requires_grad]
            grads = iter(torch.autograd.grad(L, wrt, g, allow_unused=True) if wrt else ())
        return (None, None, None, *[next(grads) if need else None for need in needs])


class AddedDiagLinearOperator(LinearOperator):
    def __init__(self, base: LinearOperator, diag_op: DiagLinearOperator):
        self.base = base
        self.diag_op = diag_op

    def _shape(self):
        return tuple(torch.broadcast_shapes(self.base.shape, self.diag_op.shape))

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def _matmul(self, rhs):
        return self.base._matmul(rhs) + self.diag_op._matmul(rhs)

    def _matmul_grad_only(self, rhs):
        return self.base._matmul_grad_only(rhs) + self.diag_op._matmul(rhs)

    def _flatten(self):
        tb, rb = self.base._flatten()
        td, rd = self.diag_op._flatten()
        nb = len(tb)
        return tb + td, lambda ts: AddedDiagLinearOperator(rb(ts[:nb]), rd(ts[nb:]))

    def _diagonal(self):
        return self.base._diagonal() + self.diag_op._diagonal()

    def _eig_lower_bound(self):
        # λ_min(K + D) ≥ λ_min(K) + min(D) (Weyl); with no bound of the base's own, min(D)
        # is a floor only for a base known to be PSD (a symmetric kernel matrix).  This is
        # the floor the Lanczos inverse root clamps its Ritz values to.
        diag_bound = self.diag_op._eig_lower_bound()
        base_bound = self.base._eig_lower_bound()
        if base_bound is not None:
            return base_bound + diag_bound
        return diag_bound if self.base._is_known_psd() else None

    def to_dense(self):
        return self.base.to_dense() + self.diag_op.to_dense()

    def _get_rows(self, idx):
        return self.base._get_rows(idx) + self.diag_op._get_rows(idx)

    def evaluate_kernel(self):
        base = self.base.evaluate_kernel()
        if base is self.base:
            return self
        return AddedDiagLinearOperator(base, self.diag_op)

    def add_diagonal(self, diag):
        return AddedDiagLinearOperator(self.base, self.diag_op.add_diagonal(diag))

    def _preconditioner(self):
        """The pivoted-Cholesky preconditioner P = LLᵀ + D as (apply_inv, precond_op,
        logdet_P): v ↦ P⁻¹v, P as a ``LowRankRootAddedDiagLinearOperator`` (for probe
        draws z ~ N(0, P)) and log|P|, differentiable; (None, None, None) when it is
        disabled or the operator is below ``min_preconditioning_size``."""
        k = settings.max_preconditioner_size.value()
        n = self.shape[-1]
        if k == 0 or n < settings.min_preconditioning_size.value():
            return None, None, None
        from ..solvers.cholesky import psd_safe_cholesky
        from ..solvers.pivoted_cholesky import pivoted_cholesky
        from .root import LowRankRootAddedDiagLinearOperator, RootLinearOperator

        rel_tol = float(settings.preconditioner_tolerance.value())
        if settings.fast_precond_grad.on():
            tensors, rebuild = self.base._flatten()
            L, _ = _PCFastGrad.apply(rebuild, k, rel_tol, *tensors)
        else:
            L = pivoted_cholesky(self.base, rank=k, rel_tol=rel_tol)
        diag = self.diag_op._diag_values()
        # τ-regularisation: P = LLᵀ + max(D, τ)I with τ = λ_max(LLᵀ)·eps/budget bounds
        # cond(P) by budget/eps, so the float32 apply noise (≈ eps·cond(P), amplified
        # λ_max-fold inside CG) stays below the budget instead of stalling CG.  Every
        # quantity below is per batch element.
        budget = float(settings.preconditioner_noise_budget.value())
        if budget > 0.0:
            mu = torch.linalg.eigvalsh(_gram(L.detach()))[..., -1]  # λ_max(LLᵀ)
            tau = mu * (torch.finfo(L.dtype).eps / budget)
            diag = torch.maximum(diag, tau if tau.ndim == 0 else tau.unsqueeze(-1))
        dinv = 1.0 / diag
        dsqrt_inv = torch.sqrt(dinv)
        Lt = L * dsqrt_inv.unsqueeze(-1)
        B = _gram(Lt)
        # log|P| = log|I + B| + log|D|, by Cholesky: differentiable, where an eigh
        # gradient would be NaN on a degenerate spectrum
        Lc = psd_safe_cholesky(torch.eye(B.shape[-1], dtype=B.dtype, device=B.device) + B, jitter=0.0, max_tries=1)
        logdet_p = 2.0 * torch.log(torch.diagonal(Lc, dim1=-2, dim2=-1)).sum(-1) + torch.log(diag).sum(-1)
        # Whitened-eigenspace apply: with Ũ = D^{-1/2}L = U S Wᵀ,
        #   P⁻¹v = D⁻¹v − Ud diag(s²/(1+s²)) Udᵀ v,   Ud = D^{-1/2}U,
        # every coefficient in [0, 1) — unlike the textbook Woodbury form, no
        # ill-conditioned k×k solve and no cancellation of two O(1/σ²) terms in float32.
        # The apply is never differentiated: it is built from detached factors.
        s2, W = torch.linalg.eigh(B.detach())
        s2 = s2.clamp_min(0.0)
        active = s2 > 1e-12 * s2.amax(-1, keepdim=True).clamp_min(1e-30)
        inv_s = torch.where(active, 1.0 / torch.sqrt(s2.clamp_min(1e-30)), torch.zeros_like(s2))
        coef = torch.where(active, s2 / (1.0 + s2), torch.zeros_like(s2)).unsqueeze(-1)
        dsqrt_inv_d = dsqrt_inv.detach().unsqueeze(-1)
        Ud = (Lt.detach() @ (W * inv_s.unsqueeze(-2))) * dsqrt_inv_d
        dinv_d = dinv.detach().unsqueeze(-1)

        def apply_inv(v):
            return v * dinv_d - Ud @ (coef * (Ud.mT @ v))

        diag_op = DiagLinearOperator(diag) if budget > 0.0 else self.diag_op
        precond_op = LowRankRootAddedDiagLinearOperator(RootLinearOperator(L), diag_op)
        return apply_inv, precond_op, logdet_p
