"""Exact GP marginal log likelihood.  Counterpart of
``gpytorch_tpu/mlls/exact_marginal_log_likelihood.py``, with the three
``settings.observation_nan_policy`` values:

* "ignore": the targets are used as they are;
* "mask": NaN targets are left out, through ``MaskedLinearOperator`` (the covariance with
  those rows and columns replaced by the identity, the target by the prior mean), and
  ½ log 2π is added back for each of them, so that the sum is log p(y_obs);
* "fill": NaN targets are replaced by the prior mean, of a multitask output too (its
  targets (…, n, t)); "mask" of a multitask output raises, as the JAX package's fails.

Either way the MLL is divided by the full number of points (n·t for t tasks), as in the
JAX package.  A batched model gives one value per batch element.  Arguments after the
target (a Hadamard likelihood's task indices) go to the likelihood.

The model's added loss terms (``Module.added_loss_terms``: SGPR's variance correction,
which ``InducingPointKernel`` sets on each training call) are added before the division,
each called with the arguments after the target, as in the JAX package.

The priors' log-densities are added once each, from this module's ``prior_log_prob_sum``
over the model and the likelihood, as GPyTorch does.  (The JAX package adds the model's
sum and then the likelihood's, and the model's already holds the likelihood, so it counts
every likelihood prior twice.)"""

from __future__ import annotations

import math

import torch

from .. import settings
from ..distributions import MultitaskMultivariateNormal, MultivariateNormal
from ..likelihoods import MultitaskGaussianLikelihood
from ..likelihoods.gaussian_likelihood import _GaussianLikelihoodBase
from ..linop import MaskedLinearOperator
from .marginal_log_likelihood import MarginalLogLikelihood


class ExactMarginalLogLikelihood(MarginalLogLikelihood):
    def __init__(self, likelihood, model):
        if not isinstance(likelihood, (_GaussianLikelihoodBase, MultitaskGaussianLikelihood)):
            raise RuntimeError("Likelihood must be Gaussian for exact inference")
        super().__init__(likelihood, model)

    def _add_other_terms(self, res: torch.Tensor, params) -> torch.Tensor:
        """``res`` plus the model's added loss terms (each called with ``params``) and the
        log-densities of the priors of the model and the likelihood, each prior once."""
        for term in self.model.added_loss_terms():
            res = res + term.loss(*params)
        prior_sum = self.prior_log_prob_sum()
        return res if prior_sum is None else res + prior_sum

    def forward(self, function_dist: MultivariateNormal, target, *params, base_samples=None, solver_state=None,
                return_state: bool = False):
        """(log p(target) + Σ added losses + Σ log p(prior values)) / N under the prior
        ``function_dist`` and the likelihood, with NaN targets treated by
        ``settings.observation_nan_policy``.

        ``base_samples`` is where the SLQ probes' base samples come from (a
        ``torch.Generator``, or a callable that returns them for a shape); pass fresh ones
        each step.  ``solver_state``/``return_state``: the rhs-only warm start of the
        training solve (``solvers/inv_quad.py``), under the policy "ignore" only; with
        ``return_state`` the call returns ``(mll, state)``, and the state goes into the
        next step's call."""
        if not isinstance(function_dist, MultivariateNormal):
            raise RuntimeError("ExactMarginalLogLikelihood requires an MVN model output")
        nan_policy = settings.observation_nan_policy.value()
        if nan_policy not in ("ignore", "mask", "fill"):
            raise ValueError(f"unknown observation_nan_policy {nan_policy!r}")
        if return_state and nan_policy != "ignore":
            raise ValueError("warm-started solves support observation_nan_policy='ignore' only")
        output = self.likelihood(function_dist, *params)
        if nan_policy == "mask" and isinstance(output, MultitaskMultivariateNormal):
            # the JAX package's "mask" fails to broadcast a multitask target (n, t) against
            # its flat mask operator; "fill" runs on either
            raise NotImplementedError("observation_nan_policy 'mask' of a multitask model is not ported")
        state = None
        if nan_policy == "ignore":
            res = output.log_prob(target, base_samples=base_samples, solver_state=solver_state,
                                  return_state=return_state)
            res, state = res if return_state else (res, None)
        else:
            observed = ~torch.isnan(target)
            filled = torch.where(observed, target, output.mean)
            if nan_policy == "mask":
                covar = MaskedLinearOperator(output.lazy_covariance_matrix.evaluate_kernel(), observed)
                res = MultivariateNormal(output.mean, covar).log_prob(filled, base_samples=base_samples)
                res = res + 0.5 * (~observed).sum(-1).to(res.dtype) * math.log(2 * math.pi)
            else:
                res = output.log_prob(filled, base_samples=base_samples)
        res = self._add_other_terms(res, params)
        num_data = function_dist.lazy_covariance_matrix.shape[-1]
        return (res / num_data, state) if return_state else res / num_data
