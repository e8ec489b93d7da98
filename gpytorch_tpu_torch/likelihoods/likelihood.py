"""Likelihood base class.  Counterpart of ``gpytorch_tpu/likelihoods/likelihood.py``:
``__call__`` on a MultivariateNormal gives the marginal p(y | x), on a tensor of function
values the conditional p(y | f).  Further positional arguments (the task indices of a
Hadamard likelihood) go to ``marginal`` and ``forward``.

The expectations under q(f) that a variational objective needs, ``expected_log_prob``
(E_q[log p(y | f)]) and ``log_marginal`` (log E_q[p(y | f)]), are Monte Carlo estimates
from ``settings.num_likelihood_samples`` draws of q(f) here; a likelihood with a closed
form overrides them.  The draws' base samples come from ``base_samples`` (a
``torch.Generator``, or a callable that returns them for a shape), in place of the JAX
package's key.  ``_OneDimensionalLikelihood`` takes them by Gauss–Hermite quadrature
instead.  ``LikelihoodList`` holds the likelihoods of a model list."""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import settings
from ..core.module import Module
from ..distributions import MultivariateNormal
from ..utils.quadrature import GaussHermiteQuadrature1D


class Likelihood(Module):
    def forward(self, function_samples: torch.Tensor, *params):
        raise NotImplementedError

    def _draw_likelihood_samples(self, function_dist: MultivariateNormal, *params, base_samples=None):
        """p(y | f) at ``settings.num_likelihood_samples`` draws f of ``function_dist``
        (the draws are the leading dimension)."""
        samples = function_dist.rsample((settings.num_likelihood_samples.value(),), base_samples)
        return self.forward(samples, *params)

    def expected_log_prob(self, observations, function_dist: MultivariateNormal, *params, base_samples=None):
        """E_{f ~ q(f)}[log p(y | f)], pointwise."""
        dist = self._draw_likelihood_samples(function_dist, *params, base_samples=base_samples)
        return dist.log_prob(observations).mean(0)

    def log_marginal(self, observations, function_dist: MultivariateNormal, *params, base_samples=None):
        """log E_{f ~ q(f)}[p(y | f)], pointwise."""
        lp = self._draw_likelihood_samples(function_dist, *params, base_samples=base_samples).log_prob(observations)
        return torch.logsumexp(lp, dim=0) - math.log(lp.shape[0])

    def marginal(self, function_dist: MultivariateNormal, *params, base_samples=None):
        """p(y | x) as the mixture of p(y | f) over draws of f."""
        return self._draw_likelihood_samples(function_dist, *params, base_samples=base_samples)

    def __call__(self, input, *params, **kwargs):
        if isinstance(input, MultivariateNormal):
            return self.marginal(input, *params, **kwargs)
        if torch.is_tensor(input):
            return self.forward(input, *params, **kwargs)
        raise NotImplementedError("a likelihood takes a MultivariateNormal or a tensor of function values")


class _OneDimensionalLikelihood(Likelihood):
    """A likelihood of scalar function values, whose ``expected_log_prob`` and
    ``log_marginal`` are Gauss–Hermite quadratures over each point's marginal of q(f)
    (``gpytorch_tpu/likelihoods/likelihood.py:68-82``) in place of Monte Carlo draws."""

    def __init__(self):
        super().__init__()
        self.quadrature = GaussHermiteQuadrature1D()

    def expected_log_prob(self, observations, function_dist: MultivariateNormal, *params, **kwargs):
        return self.quadrature(lambda f: self.forward(f, *params).log_prob(observations), function_dist)

    def log_marginal(self, observations, function_dist: MultivariateNormal, *params, **kwargs):
        prob = self.quadrature(lambda f: self.forward(f, *params).log_prob(observations).exp(), function_dist)
        return prob.clamp_min(1e-30).log()


class LikelihoodList(Module):
    """One likelihood per model of an ``IndependentModelList``
    (``gpytorch_tpu/likelihoods/likelihood.py:85-98``): called with one list of inputs, or
    with one argument per likelihood, it returns the list of each likelihood's output."""

    def __init__(self, *likelihoods):
        super().__init__()
        self.likelihoods = nn.ModuleList(likelihoods)

    def forward(self, *args):
        if len(args) == 1 and isinstance(args[0], (list, tuple)):
            args = args[0]
        return [likelihood(a) for likelihood, a in zip(self.likelihoods, args)]
