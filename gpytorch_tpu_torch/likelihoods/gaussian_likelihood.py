"""Gaussian likelihoods.  Counterpart of ``GaussianLikelihood`` and
``HadamardGaussianLikelihood`` in ``gpytorch_tpu/likelihoods/gaussian_likelihood.py``."""

from __future__ import annotations

import math

import torch

from ..distributions import MultivariateNormal
from ..linop import DiagLinearOperator
from .likelihood import Likelihood
from .noise_models import HomoskedasticNoise, MultitaskHomoskedasticNoise


class _GaussianLikelihoodBase(Likelihood):
    """The likelihoods whose marginal adds a diagonal noise to the covariance, and whose
    expectations under a Gaussian q(f) are closed forms."""

    def __init__(self, noise_covar):
        super().__init__()
        self.noise_covar = noise_covar

    def _noise_diag(self, shape, *params) -> torch.Tensor:
        """σ² at every point of a tensor of ``shape``."""
        return self.noise_covar(shape)._diagonal().expand(shape)

    def forward(self, function_samples: torch.Tensor, *params) -> torch.distributions.Normal:
        """p(y | f) = N(f, σ²) at every point."""
        noise = self._noise_diag(function_samples.shape, *params)
        return torch.distributions.Normal(function_samples, noise.sqrt(), validate_args=False)

    def expected_log_prob(self, target, function_dist: MultivariateNormal, *params, base_samples=None):
        """E_q[log p(y | f)] = −½[((y − μ)² + σ_f²)/σ² + log σ² + log 2π] per point."""
        mean, variance = function_dist.mean, function_dist.variance
        noise = self._noise_diag(mean.shape, *params)
        return -0.5 * (((target - mean) ** 2 + variance) / noise + torch.log(noise) + math.log(2 * math.pi))

    def log_marginal(self, observations, function_dist: MultivariateNormal, *params, base_samples=None):
        """log N(y; μ, σ_f² + σ²) per point."""
        return self.marginal(function_dist, *params).to_data_independent_dist().log_prob(observations)


class GaussianLikelihood(_GaussianLikelihoodBase):
    """Homoskedastic noise σ², one per batch element under ``batch_shape``."""

    def __init__(self, noise_prior=None, noise_constraint=None, batch_shape=()):
        super().__init__(HomoskedasticNoise(noise_prior, noise_constraint, batch_shape))

    @property
    def noise(self) -> torch.Tensor:
        return self.noise_covar.noise

    @noise.setter
    def noise(self, value) -> None:
        self.noise_covar.noise = value

    def marginal(self, function_dist: MultivariateNormal, *params) -> MultivariateNormal:
        """p(y | x) = N(μ, K + σ²I)."""
        mean = function_dist.loc
        return MultivariateNormal(mean, function_dist.lazy_covariance_matrix + self.noise_covar(mean.shape))


class HadamardGaussianLikelihood(_GaussianLikelihoodBase):
    """One noise σ²_t per task, chosen at each point by its task index
    (``gpytorch_tpu/likelihoods/gaussian_likelihood.py:196-220``): the likelihood of a
    Hadamard multitask GP, whose points each carry one task.

    The task indices are the first positional argument after the distribution, read as
    the JAX package reads them: cast to integers, and column 0 of a 2-D argument.  A
    prediction strategy passes the training inputs there, so a model whose inputs hold the
    task in column 0 can be served."""

    def __init__(self, num_tasks: int, noise_prior=None, noise_constraint=None, batch_shape=()):
        super().__init__(MultitaskHomoskedasticNoise(num_tasks, noise_prior, noise_constraint, batch_shape))
        self.num_tasks = int(num_tasks)

    @property
    def task_noises(self) -> torch.Tensor:
        return self.noise_covar.noise

    def _task_indices(self, params) -> torch.Tensor:
        if not params:
            raise RuntimeError("HadamardGaussianLikelihood needs the task indices")
        idx = params[0].long()
        return idx[..., 0] if idx.ndim > 1 else idx

    def _noise_diag(self, shape, *params) -> torch.Tensor:
        noise = self.noise_covar.noise  # (*batch, num_tasks)
        idx = self._task_indices(params)
        return torch.take_along_dim(noise, idx.expand(noise.shape[:-1] + idx.shape[-1:]), dim=-1).expand(shape)

    def marginal(self, function_dist: MultivariateNormal, *params) -> MultivariateNormal:
        """p(y | x) = N(μ, K + diag(σ²_{task(i)}))."""
        point_noise = self._noise_diag(function_dist.loc.shape, *params)
        return MultivariateNormal(function_dist.loc, function_dist.lazy_covariance_matrix + DiagLinearOperator(point_noise))
