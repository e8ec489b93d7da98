"""Variational distributions in natural coordinates, for natural-gradient descent.
Counterpart of ``gpytorch_tpu/variational/natural_variational_distribution.py``.

The parameters are θ = (S⁻¹μ, −½S⁻¹) (``NaturalVariationalDistribution``), or S⁻¹μ and a
lower-triangular W with S⁻¹ = W Wᵀ (``TrilNaturalVariationalDistribution``).  The
conversion θ → (μ, Σ) is a ``torch.autograd.Function`` whose backward returns, in place of
the Euclidean gradient, the gradient with respect to the expectation parameters
η = (μ, Σ + μμᵀ): ∂L/∂η₁ = μ̄ − 2Σ̄μ and ∂L/∂η₂ = sym(Σ̄), the JAX package's custom VJP.
The natural gradient of θ is that expectation gradient, so plain gradient descent on θ
(``optim.NGD``) is natural-gradient descent.  With ``TrilNaturalVariationalDistribution``
autograd chains it on through −½ W Wᵀ.
"""

from __future__ import annotations

import torch

from ..distributions import MultivariateNormal
from ..linop import CholLinearOperator
from ..solvers.cholesky import psd_safe_cholesky
from ._variational_distribution import _assign, _VariationalDistribution


def _symmetrize(A: torch.Tensor) -> torch.Tensor:
    return 0.5 * (A + A.mT)


class _NaturalToMuSigma(torch.autograd.Function):
    """(S⁻¹μ, −½S⁻¹) → (μ, Σ); the backward gives the expectation-parameter gradients."""

    @staticmethod
    def forward(ctx, nat_vec, nat_mat):
        L_prec = psd_safe_cholesky(-2.0 * _symmetrize(nat_mat))
        eye = torch.eye(nat_mat.shape[-1], dtype=nat_mat.dtype, device=nat_mat.device)
        sigma = _symmetrize(torch.cholesky_solve(eye.expand_as(L_prec), L_prec))
        mu = (sigma @ nat_vec.unsqueeze(-1)).squeeze(-1)
        ctx.save_for_backward(mu)
        return mu, sigma

    @staticmethod
    def backward(ctx, mu_bar, sigma_bar):
        (mu,) = ctx.saved_tensors
        sigma_bar = _symmetrize(sigma_bar)
        return mu_bar - 2.0 * (sigma_bar @ mu.unsqueeze(-1)).squeeze(-1), sigma_bar


def natural_to_mu_sigma(nat_vec: torch.Tensor, nat_mat: torch.Tensor):
    """(μ, Σ) of the natural parameters (S⁻¹μ, −½S⁻¹), differentiated as the module says."""
    return _NaturalToMuSigma.apply(nat_vec, nat_mat)


def _prior_precision(prior_dist: MultivariateNormal) -> torch.Tensor:
    cov = prior_dist.lazy_covariance_matrix.evaluate_kernel().to_dense()
    L = psd_safe_cholesky(cov)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    return torch.cholesky_solve(eye.expand_as(L), L)


class _NaturalVariationalDistribution(_VariationalDistribution):
    """Marks a q(u) whose parameters are natural coordinates."""


class NaturalVariationalDistribution(_NaturalVariationalDistribution):
    """Parameters ``natural_vec`` = S⁻¹μ and ``natural_mat`` = −½S⁻¹."""

    def __init__(self, num_inducing_points: int, batch_shape=(), mean_init_std: float = 1e-3):
        super().__init__(num_inducing_points, batch_shape, mean_init_std)
        m = self.num_inducing_points
        self.register_parameter("natural_vec", torch.nn.Parameter(torch.zeros(self.shape())))
        self.register_parameter("natural_mat",
                                torch.nn.Parameter((-0.5 * torch.eye(m)).expand(self.batch_shape + (m, m)).clone()))

    def forward(self) -> MultivariateNormal:
        mu, sigma = natural_to_mu_sigma(self.natural_vec, self.natural_mat)
        return MultivariateNormal(mu, CholLinearOperator(psd_safe_cholesky(sigma)))

    def initialize_variational_distribution(self, prior_dist, generator=None):
        mean = self._perturbed_mean(prior_dist, generator)
        prec = _prior_precision(prior_dist)
        _assign(self.natural_vec, (prec @ mean.unsqueeze(-1)).squeeze(-1))
        _assign(self.natural_mat, -0.5 * prec)


class TrilNaturalVariationalDistribution(_NaturalVariationalDistribution):
    """Parameters ``natural_vec`` = S⁻¹μ and ``natural_tril_mat`` = W, lower triangular, with
    S⁻¹ = W Wᵀ."""

    def __init__(self, num_inducing_points: int, batch_shape=(), mean_init_std: float = 1e-3):
        super().__init__(num_inducing_points, batch_shape, mean_init_std)
        m = self.num_inducing_points
        self.register_parameter("natural_vec", torch.nn.Parameter(torch.zeros(self.shape())))
        self.register_parameter("natural_tril_mat",
                                torch.nn.Parameter(torch.eye(m).expand(self.batch_shape + (m, m)).clone()))

    def forward(self) -> MultivariateNormal:
        W = torch.tril(self.natural_tril_mat)
        mu, sigma = natural_to_mu_sigma(self.natural_vec, -0.5 * W @ W.mT)
        return MultivariateNormal(mu, CholLinearOperator(psd_safe_cholesky(sigma)))

    def initialize_variational_distribution(self, prior_dist, generator=None):
        mean = self._perturbed_mean(prior_dist, generator)
        prec = _prior_precision(prior_dist)
        _assign(self.natural_vec, (prec @ mean.unsqueeze(-1)).squeeze(-1))
        _assign(self.natural_tril_mat, psd_safe_cholesky(prec))
