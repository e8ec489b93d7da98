"""Exact GP marginal log likelihood.  Counterpart of
``gpytorch_tpu/mlls/exact_marginal_log_likelihood.py``, with observation_nan_policy
"ignore" (targets are used as they are) and no added loss terms.

The priors' log-densities are added once each, from this module's ``prior_log_prob_sum``
over the model and the likelihood, as GPyTorch does.  (The JAX package adds the model's
sum and then the likelihood's, and the model's already holds the likelihood, so it counts
every likelihood prior twice.)"""

from __future__ import annotations

from ..distributions import MultivariateNormal
from ..likelihoods import GaussianLikelihood
from .marginal_log_likelihood import MarginalLogLikelihood


class ExactMarginalLogLikelihood(MarginalLogLikelihood):
    def __init__(self, likelihood, model):
        if not isinstance(likelihood, GaussianLikelihood):
            raise RuntimeError("Likelihood must be Gaussian for exact inference")
        super().__init__(likelihood, model)

    def forward(self, function_dist: MultivariateNormal, target, base_samples=None, solver_state=None,
                return_state: bool = False):
        """(log p(target) + Σ log p(prior values)) / N under the prior ``function_dist`` and
        the likelihood.

        ``base_samples`` is where the SLQ probes' base samples come from (a
        ``torch.Generator``, or a callable that returns them for a shape); pass fresh ones
        each step.  ``solver_state``/``return_state``: the rhs-only warm start of the
        training solve (``solvers/inv_quad.py``); with ``return_state`` the call returns
        ``(mll, state)``, and the state goes into the next step's call."""
        if not isinstance(function_dist, MultivariateNormal):
            raise RuntimeError("ExactMarginalLogLikelihood requires an MVN model output")
        output = self.likelihood(function_dist)
        res = output.log_prob(target, base_samples=base_samples, solver_state=solver_state, return_state=return_state)
        res, state = res if return_state else (res, None)
        prior_sum = self.prior_log_prob_sum()
        if prior_sum is not None:
            res = res + prior_sum
        num_data = function_dist.lazy_covariance_matrix.shape[-1]
        return (res / num_data, state) if return_state else res / num_data
