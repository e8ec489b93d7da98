"""``PredictiveLogLikelihood`` (PPGPR).  Counterpart of
``gpytorch_tpu/mlls/predictive_log_likelihood.py``: the likelihood term is
Σ log E_q[p(y | f)], in place of the ELBO's Σ E_q[log p(y | f)]."""

from __future__ import annotations

from ._approximate_mll import _ApproximateMarginalLogLikelihood
from .variational_elbo import _sum_event


class PredictiveLogLikelihood(_ApproximateMarginalLogLikelihood):
    def _log_likelihood_term(self, variational_dist_f, target, **kwargs):
        return _sum_event(self.likelihood.log_marginal(target, variational_dist_f, **kwargs), variational_dist_f)
