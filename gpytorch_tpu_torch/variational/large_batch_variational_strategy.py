"""The large-batch variational strategy.  Counterpart of
``gpytorch_tpu/variational/large_batch_variational_strategy.py``.

The whitened strategy's function, computed for large minibatches and a moderate number of
inducing points m: the middle term M = L⁻ᵀ(S − I)L⁻¹ (m × m, L the Cholesky factor of
K_ZZ + jitter) is grouped once, so that

    μ_f = μ_x + K_xZ L⁻ᵀ m,    Σ_f = K_xx + K_xZ M K_Zx,

and in training, where the ELBO reads only the marginal variances, Σ_f is the diagonal
K_xx's diagonal + diag(K_xZ M K_Zx), by ``quad_form_diagonal``, whose backward forms no
(m × n)·(n × m) product.  In eval mode Σ_f is K_xx plus K_xZ · (M K_Zx).  K_ZZ and K_Zx are
evaluated densely and no kernel product is launched.

M's entries grow with the condition of K_ZZ + jitter, and K_xZ M K_Zx is a small difference
of them: in float32 the gradient of the ELBO read 0.81 of its largest entry off float64 at a
trained state (m = 1,024, jitter 1e-4, a minibatch of 4,096, CPU), where the whitened
strategy's read 2e-4.  So, as GPyTorch does on a GPU, L, M, the mean's solve and the variance
term are computed in ``settings._linalg_dtype_cholesky``'s dtype (float64 by default) when it
is wider than the inputs', and cast back; in eval mode K_xZ M K_Zx is then formed densely in
that dtype.  The JAX package keeps the inputs' dtype (its TPU has no fast float64); in float64
the two compute the same.
"""

from __future__ import annotations

import torch

from .. import settings
from ..distributions import MultivariateNormal
from ..linop import DenseLinearOperator, DiagLinearOperator, MatmulLinearOperator, SumLinearOperator
from ..solvers.cholesky import psd_safe_cholesky
from .variational_strategy import VariationalStrategy, _joint_prior


class _QuadFormDiagonal(torch.autograd.Function):
    """diag(rhsᵀ M rhs) for a symmetric M (…, m, m) and rhs (…, m, n), with the JAX package's
    VJP: M̄ = rhs (d ⊙ rhsᵀ) and rhs̄ = 2 (M rhs) ⊙ d for the cotangent d (…, n)."""

    @staticmethod
    def forward(ctx, matrix, rhs):
        product = matrix @ rhs
        ctx.save_for_backward(rhs, product)
        return (rhs * product).sum(-2)

    @staticmethod
    def backward(ctx, d_diag):
        rhs, product = ctx.saved_tensors
        d_matrix = rhs @ (d_diag.unsqueeze(-1) * rhs.mT) if ctx.needs_input_grad[0] else None
        d_rhs = 2.0 * product * d_diag.unsqueeze(-2) if ctx.needs_input_grad[1] else None
        return d_matrix, d_rhs


def quad_form_diagonal(matrix: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """diag(rhsᵀ · matrix · rhs), (…, n), for a symmetric ``matrix``."""
    return _QuadFormDiagonal.apply(matrix, rhs)


def _expand(a: torch.Tensor, b: torch.Tensor):
    """a and b broadcast to their common batch shape."""
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return a.expand(batch + a.shape[-2:]), b.expand(batch + b.shape[-2:])


class LargeBatchVariationalStrategy(VariationalStrategy):
    def forward(self, x, inducing_points, inducing_values, variational_inducing_covar=None, model=None, **kwargs):
        model = self._resolve_model(model)
        _, test_mean, K_ZZ, K_Zx, K_xx = _joint_prior(model, inducing_points, x)
        dtype = test_mean.dtype
        wide = settings._linalg_dtype_cholesky.value()
        work = wide if wide is not None and torch.finfo(wide).bits > torch.finfo(dtype).bits else dtype
        L = psd_safe_cholesky(K_ZZ.evaluate_kernel().add_jitter(self.jitter_val).to_dense().to(work))
        K_Zx = K_Zx.evaluate_kernel().to_dense().to(work)
        Lt, m_col = _expand(L.mT, inducing_values.unsqueeze(-1).to(work))
        pred_mean = (K_Zx.mT @ torch.linalg.solve_triangular(Lt, m_col, upper=True)).squeeze(-1).to(dtype) + test_mean
        eye = torch.eye(L.shape[-1], dtype=work, device=L.device)
        middle = -eye if variational_inducing_covar is None else variational_inducing_covar.to_dense().to(work) - eye
        Lt, middle = _expand(L.mT, middle)
        middle = torch.linalg.solve_triangular(Lt, middle, upper=True)  # L⁻ᵀ(S − I)
        middle = torch.linalg.solve_triangular(Lt, middle.mT, upper=True)  # L⁻ᵀ(S − I)L⁻¹
        if self.training:
            var_update = quad_form_diagonal(*_expand(middle, K_Zx)).to(dtype)
            return MultivariateNormal(pred_mean, DiagLinearOperator(K_xx._diagonal() + var_update))
        if work != dtype:
            correction = DenseLinearOperator((K_Zx.mT @ (middle @ K_Zx)).to(dtype))
        else:
            correction = MatmulLinearOperator(DenseLinearOperator(K_Zx.mT), DenseLinearOperator(middle @ K_Zx))
        return MultivariateNormal(pred_mean, SumLinearOperator(K_xx, correction))
