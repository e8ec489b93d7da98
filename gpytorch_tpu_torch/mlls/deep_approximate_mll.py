"""``DeepApproximateMLL``.  Counterpart of ``gpytorch_tpu/mlls/deep_approximate_mll.py``: a
base variational objective (``VariationalELBO``, with ``combine_terms``) on a ``DeepGP``'s
output, its likelihood term averaged over the sample dimension (dim 0) and the KL terms of
every layer (``DeepGP.deep_kl_divergence``).  ``DeepPredictiveLogLikelihood`` (deep sigma
point processes) is not ported."""

from __future__ import annotations

from .marginal_log_likelihood import MarginalLogLikelihood


class DeepApproximateMLL(MarginalLogLikelihood):
    def __init__(self, base_mll):
        if not base_mll.combine_terms:
            raise ValueError("The base marginal log likelihood object should combine terms.")
        super().__init__(base_mll.likelihood, base_mll.model)
        self.base_mll = base_mll

    def forward(self, approximate_dist_f, target, **kwargs):
        base = self.base_mll
        ll = base._log_likelihood_term(approximate_dist_f, target, **kwargs) / approximate_dist_f.event_shape[0]
        if ll.ndim > 0:
            ll = ll.mean(0)
        res = ll - self.model.deep_kl_divergence() * (base.beta / base.num_data)
        log_prior = self.model.prior_log_prob_sum()
        if log_prior is not None:
            res = res + log_prior / base.num_data
        for term in self.model.added_loss_terms():
            res = res - term.loss()
        return res
