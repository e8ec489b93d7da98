"""Decoupled variational strategies: inducing points of their own for the mean and for the
covariance.  Counterpart of ``gpytorch_tpu/variational/decoupled_variational_strategies.py``.

``OrthogonallyDecoupledVariationalStrategy`` (Salimbeni et al. 2018, arXiv 1809.08820): many
mean inducing points Z_m with a point-mass q(u) (``DeltaVariationalDistribution``, values m),
over a wrapped strategy that carries the covariance and plays the model's part.  With the
wrapped strategy's q(f) over [x; Z_m] (one call, densified over those rows),

    μ_f = μ_base(x) + Σ_base(x, Z_m) m,    Σ_f = Σ_base(x, x),

and its KL is the wrapped strategy's plus ½ mᵀ(Σ_base(Z_m, Z_m) + jitter) m, a product with
the wrapped strategy's covariance at Z_m, whose K(Z_m, Z_m) part is the lazy kernel operator
(above ``max_eager_kernel_size``² a fused K·V launch).  The wrapped strategy is a registered
submodule (``base_variational_strategy``); the reference to it kept as the "model" stays out
of ``nn.Module``'s registry, as every strategy's model reference does.

``BatchDecoupledVariationalStrategy`` (Jankowiak et al. 2020): the inducing points stacked
twice on a batch dimension of size 2 (``mean_var_batch_dim``, or a new dimension −3), so
that a kernel with that batch dimension has one set of hyperparameters for the mean and one
for the variance.  With A_k = L_k⁻¹ K_k(Z, x) of batch element k (L_k the Cholesky factor of
K_k(Z, Z) + jitter),

    μ_f = μ_0(x) + A_0ᵀ m,    Σ_f = K_1(x, x) + jitter + A_1ᵀ(S − I)A_1,

and its KL is −log p(m) + KL(N(0, S) ‖ p) for the whitened prior p = N(0, I).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..distributions import MultivariateNormal, kl_divergence
from ..linop import DenseLinearOperator, MatmulLinearOperator, SumLinearOperator
from ..solvers.cholesky import psd_safe_cholesky
from ._variational_distribution import DeltaVariationalDistribution
from ._variational_strategy import _VariationalStrategy
from .variational_strategy import VariationalStrategy, _joint_prior


class OrthogonallyDecoupledVariationalStrategy(_VariationalStrategy):
    def __init__(self, covar_variational_strategy, inducing_points, variational_distribution,
                 jitter_val: Optional[float] = None):
        if not isinstance(variational_distribution, DeltaVariationalDistribution):
            raise NotImplementedError(
                "OrthogonallyDecoupledVariationalStrategy currently works with DeltaVariationalDistribution")
        super().__init__(covar_variational_strategy, inducing_points, variational_distribution,
                         learn_inducing_locations=True, jitter_val=jitter_val)
        self.base_variational_strategy = covar_variational_strategy

    def prior_distribution(self, model=None) -> MultivariateNormal:
        """The wrapped strategy's q(f) at the mean inducing points, plus jitter."""
        out = self.base_variational_strategy(self.inducing_points, model=model)
        return MultivariateNormal(out.loc, out.lazy_covariance_matrix.evaluate_kernel().add_jitter(self.jitter_val))

    def forward(self, x, inducing_points, inducing_values, variational_inducing_covar=None, model=None, **kwargs):
        if variational_inducing_covar is not None:
            raise NotImplementedError(
                "OrthogonallyDecoupledVariationalStrategy currently works with DeltaVariationalDistribution")
        n = x.shape[-2]
        full = self.base_variational_strategy(torch.cat([x, inducing_points], dim=-2), model=model, **kwargs)
        covar = full.lazy_covariance_matrix.to_dense()
        pred_mean = (covar[..., :n, n:] @ inducing_values.unsqueeze(-1)).squeeze(-1) + full.loc[..., :n]
        return MultivariateNormal(pred_mean, DenseLinearOperator(covar[..., :n, :n]))

    def kl_divergence(self, model=None) -> torch.Tensor:
        mean = self.variational_distribution.mean
        induc_induc_covar = self.prior_distribution(model).lazy_covariance_matrix
        kl = self.base_variational_strategy.kl_divergence(model=model)
        return kl + 0.5 * (induc_induc_covar.matmul(mean.unsqueeze(-1)).squeeze(-1) * mean).sum(-1)


class BatchDecoupledVariationalStrategy(VariationalStrategy):
    def __init__(self, model, inducing_points, variational_distribution, learn_inducing_locations: bool = True,
                 mean_var_batch_dim: Optional[int] = None, jitter_val: Optional[float] = None):
        if isinstance(variational_distribution, DeltaVariationalDistribution):
            raise NotImplementedError("BatchDecoupledVariationalStrategy does not work with DeltaVariationalDistribution")
        if mean_var_batch_dim is not None and mean_var_batch_dim >= 0:
            raise ValueError(f"mean_var_batch_dim should be negative indexed, got {mean_var_batch_dim}")
        if inducing_points.ndim == 1:
            inducing_points = inducing_points.unsqueeze(-1)
        stack_dim = (mean_var_batch_dim - 2) if mean_var_batch_dim is not None else -3
        inducing_points = torch.stack([inducing_points, inducing_points], dim=stack_dim)
        super().__init__(model, inducing_points, variational_distribution,
                         learn_inducing_locations=learn_inducing_locations, jitter_val=jitter_val)
        self.mean_var_batch_dim = mean_var_batch_dim

    def __call__(self, x, prior: bool = False, model=None, **kwargs):
        if x.ndim == 1:
            x = x.unsqueeze(-1)
        if not prior:  # the mean/variance batch dimension, of size 1, broadcast against Z's
            x = x.unsqueeze((self.mean_var_batch_dim - 2) if self.mean_var_batch_dim is not None else -3)
        return super().__call__(x, prior=prior, model=model, **kwargs)

    def forward(self, x, inducing_points, inducing_values, variational_inducing_covar=None, model=None, **kwargs):
        model = self._resolve_model(model)
        mean_var_batch_dim = self.mean_var_batch_dim or -1
        _, test_mean, K_ZZ, K_Zx, K_xx = _joint_prior(model, inducing_points, x)
        L = psd_safe_cholesky(K_ZZ.evaluate_kernel().add_jitter(self.jitter_val).to_dense())
        interp = torch.linalg.solve_triangular(L, K_Zx.evaluate_kernel().to_dense(), upper=False)  # (…, 2, m, n)
        sel_dim = mean_var_batch_dim - 2  # the pair's dimension in interp's batch
        mean_interp, var_interp = interp.select(sel_dim, 0), interp.select(sel_dim, 1)
        pred_mean = ((mean_interp * inducing_values.unsqueeze(-1)).sum(-2)
                     + test_mean.select(mean_var_batch_dim - 1, 0))
        eye = torch.eye(inducing_points.shape[-2], dtype=var_interp.dtype, device=var_interp.device)
        middle = variational_inducing_covar.to_dense() - eye
        data_covar_var = K_xx.evaluate_kernel().add_jitter(self.jitter_val).to_dense().select(sel_dim, 1)
        pred_covar = SumLinearOperator(DenseLinearOperator(data_covar_var),
                                       MatmulLinearOperator(DenseLinearOperator(var_interp.mT),
                                                            DenseLinearOperator(middle @ var_interp)))
        return MultivariateNormal(pred_mean, pred_covar)

    def kl_divergence(self, model=None) -> torch.Tensor:
        q = self.variational_distribution
        prior = self.prior_distribution(model)
        zero_mean_q = MultivariateNormal(torch.zeros_like(q.mean), q.lazy_covariance_matrix)
        return -prior.log_prob(q.mean) + kl_divergence(zero_mean_q, prior)
