"""Homoskedastic Gaussian likelihood.  Counterpart of ``GaussianLikelihood`` in
``gpytorch_tpu/likelihoods/gaussian_likelihood.py``."""

from __future__ import annotations

import torch

from ..distributions import MultivariateNormal
from .likelihood import Likelihood
from .noise_models import HomoskedasticNoise


class GaussianLikelihood(Likelihood):
    def __init__(self, noise_prior=None, noise_constraint=None):
        super().__init__()
        self.noise_covar = HomoskedasticNoise(noise_prior, noise_constraint)

    @property
    def noise(self) -> torch.Tensor:
        return self.noise_covar.noise

    @noise.setter
    def noise(self, value) -> None:
        self.noise_covar.noise = value

    def marginal(self, function_dist: MultivariateNormal) -> MultivariateNormal:
        """p(y | x) = N(μ, K + σ²I)."""
        mean = function_dist.loc
        return MultivariateNormal(mean, function_dist.lazy_covariance_matrix + self.noise_covar(mean.shape))
