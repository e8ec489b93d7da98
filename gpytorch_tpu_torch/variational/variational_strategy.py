"""The whitened and unwhitened variational strategies.  Counterpart of
``gpytorch_tpu/variational/variational_strategy.py``.

Both take one kernel evaluation over the joint inputs [Z; x] (``join_rows``, so that each
block's slice is its own inputs) and a dense Cholesky factor L of K_ZZ + jitter.  K_ZZ and
K_Zx are evaluated densely; K_xx stays the lazy kernel operator, of which a variational
objective reads only the diagonal, so neither ``forward`` launches a kernel product.

Whitened (``VariationalStrategy``): q(u) lives on u' = L⁻¹(u − μ_Z), whose prior is N(0, I),
and with A = L⁻¹ K_Zx
    μ_f = μ_x + Aᵀ m,    Σ_f = K_xx + Aᵀ S A − Aᵀ A.
Its KL against N(0, I) is closed form at every m (``IdentityLinearOperator``).

Unwhitened (``UnwhitenedVariationalStrategy``): q(u) lives on u itself, whose prior is
N(μ_Z, K_ZZ + jitter), and with A = K_ZZ⁻¹ K_Zx (two triangular solves)
    μ_f = μ_x + Aᵀ (m − μ_Z),    Σ_f = K_xx − K_xZ K_ZZ⁻¹ K_Zx + Aᵀ S A.
Its KL reads the prior's log-determinant and K_ZZ⁻¹[L_S | μ_Z − m]: by a dense Cholesky up to
``settings.max_cholesky_size`` inducing points, above it by mBCG on the lazy K_ZZ + jitter
(K_ZZ is kept lazy above ``max_eager_kernel_size``²), which launches the K·V kernel.

Each strategy's ``pseudo_points`` gives the pseudo-observations of online variational
conditioning (``_pseudo_points_from``; ``_variational_strategy.py``).
"""

from __future__ import annotations

import torch

from ..distributions import MultivariateNormal
from ..linop import IdentityLinearOperator, RootLinearOperator, SumLinearOperator, join_rows
from ..solvers.cholesky import psd_safe_cholesky
from ._variational_strategy import _VariationalStrategy


def _pseudo_points_from(var_chol, var_mean, cov_diff, K_root, jitter_val: float, whitened: bool):
    """The pseudo-points (D̃, ỹ − μ_Z) of online variational conditioning
    (``gpytorch_tpu/variational/variational_strategy.py:34-60``): with S = L_S L_Sᵀ and
    R = I − S (whitened) or K_ZZ − S (unwhitened),

        D̃ = S + S (R Rᵀ + εI)⁻¹ Rᵀ S,   ỹ − μ_Z = (R Rᵀ + εI)⁻¹ Rᵀ m  (whitened)
                                          or m + S (R Rᵀ + εI)⁻¹ Rᵀ m  (unwhitened),

    the normal equations standing in for R⁻¹ (R need not be definite); whitened values
    are mapped back through K_root, the Cholesky factor of K_ZZ + jitter.  D̃ symmetrised."""
    S = var_chol @ var_chol.mT
    m_vec = var_mean.unsqueeze(-1)
    eye = torch.eye(cov_diff.shape[-1], dtype=cov_diff.dtype, device=cov_diff.device)
    L_inner = psd_safe_cholesky(cov_diff @ cov_diff.mT + jitter_val * eye)
    pseudo_covar = S + S @ torch.cholesky_solve(cov_diff.mT @ S, L_inner)
    inner_mean = torch.cholesky_solve(cov_diff.mT @ m_vec, L_inner)
    if whitened:
        pseudo_covar = K_root @ pseudo_covar @ K_root.mT
        pseudo_mean = K_root @ inner_mean
    else:
        pseudo_mean = m_vec + S @ inner_mean
    return 0.5 * (pseudo_covar + pseudo_covar.mT), pseudo_mean


def _cholesky_q(strategy):
    from ._variational_distribution import CholeskyVariationalDistribution

    vd = strategy._variational_distribution
    if not isinstance(vd, CholeskyVariationalDistribution):
        raise NotImplementedError("pseudo points require CholeskyVariationalDistribution")
    return torch.tril(vd.chol_variational_covar), vd.variational_mean


def _joint_prior(model, inducing_points, x):
    """(μ_Z, μ_x, K_ZZ, K_Zx, K_xx) from one ``model.forward`` over [Z; x]: K_ZZ and K_Zx as
    the kernel operator's slices, K_xx lazy."""
    m = inducing_points.shape[-2]
    full = model.forward(join_rows(inducing_points, x))
    covar = full.lazy_covariance_matrix
    return (full.loc[..., :m], full.loc[..., m:], covar[..., :m, :m], covar[..., :m, m:],
            covar[..., m:, m:].evaluate_kernel())


class VariationalStrategy(_VariationalStrategy):
    def pseudo_points(self, model=None):
        """Whitened: R = I − S, mapped back through chol(K_ZZ + jitter)."""
        var_chol, var_mean = _cholesky_q(self)
        K_ZZ = self._resolve_model(model).forward(self.inducing_points).lazy_covariance_matrix.evaluate_kernel()
        K_root = psd_safe_cholesky(K_ZZ.add_jitter(self.jitter_val).to_dense())
        eye = torch.eye(var_chol.shape[-1], dtype=var_chol.dtype, device=var_chol.device)
        return _pseudo_points_from(var_chol, var_mean, eye - var_chol @ var_chol.mT, K_root, self.jitter_val, True)

    def prior_distribution(self, model=None) -> MultivariateNormal:
        """N(0, I) over the whitened inducing values."""
        m, batch = self._variational_distribution.num_inducing_points, self._variational_distribution.batch_shape
        Z = self.inducing_points
        return MultivariateNormal(torch.zeros(batch + (m,), dtype=Z.dtype, device=Z.device),
                                  IdentityLinearOperator(m, Z.dtype, Z.device, batch))

    def forward(self, x, inducing_points, inducing_values, variational_inducing_covar=None, model=None, **kwargs):
        model = self._resolve_model(model)
        _, test_mean, K_ZZ, K_Zx, K_xx = _joint_prior(model, inducing_points, x)
        L = psd_safe_cholesky(K_ZZ.evaluate_kernel().add_jitter(self.jitter_val).to_dense())
        interp = torch.linalg.solve_triangular(L, K_Zx.evaluate_kernel().to_dense(), upper=False)  # (..., m, n)
        pred_mean = (interp.mT @ inducing_values.unsqueeze(-1)).squeeze(-1) + test_mean
        parts = [K_xx]
        if variational_inducing_covar is not None:
            parts.append(RootLinearOperator(interp.mT @ variational_inducing_covar.root_decomposition().root))
        return MultivariateNormal(pred_mean, SumLinearOperator(*parts, RootLinearOperator(interp.mT) * -1.0))


class UnwhitenedVariationalStrategy(_VariationalStrategy):
    def pseudo_points(self, model=None):
        """Unwhitened: R = K_ZZ − S."""
        var_chol, var_mean = _cholesky_q(self)
        K_ZZ = self._resolve_model(model).forward(self.inducing_points).lazy_covariance_matrix.evaluate_kernel()
        return _pseudo_points_from(var_chol, var_mean, K_ZZ.to_dense() - var_chol @ var_chol.mT, None,
                                   self.jitter_val, False)

    def prior_distribution(self, model=None) -> MultivariateNormal:
        """N(μ_Z, K_ZZ + jitter), the kernel lazy above ``max_eager_kernel_size``²."""
        out = self._resolve_model(model).forward(self.inducing_points)
        return MultivariateNormal(out.loc, out.lazy_covariance_matrix.evaluate_kernel().add_jitter(self.jitter_val))

    def forward(self, x, inducing_points, inducing_values, variational_inducing_covar=None, model=None, **kwargs):
        model = self._resolve_model(model)
        induc_mean, test_mean, K_ZZ, K_Zx, K_xx = _joint_prior(model, inducing_points, x)
        L = psd_safe_cholesky(K_ZZ.evaluate_kernel().add_jitter(self.jitter_val).to_dense())
        tmp = torch.linalg.solve_triangular(L, K_Zx.evaluate_kernel().to_dense(), upper=False)  # L⁻¹ K_Zx
        A = torch.linalg.solve_triangular(L.mT, tmp, upper=True)  # K_ZZ⁻¹ K_Zx
        pred_mean = test_mean + (A.mT @ (inducing_values - induc_mean).unsqueeze(-1)).squeeze(-1)
        parts = [K_xx, RootLinearOperator(tmp.mT) * -1.0]
        if variational_inducing_covar is not None:
            parts.append(RootLinearOperator(A.mT @ variational_inducing_covar.root_decomposition().root))
        return MultivariateNormal(pred_mean, SumLinearOperator(*parts))
