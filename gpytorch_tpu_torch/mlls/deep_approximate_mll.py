"""``DeepApproximateMLL``.  Counterpart of ``gpytorch_tpu/mlls/deep_approximate_mll.py``: a
base variational objective (``VariationalELBO``, with ``combine_terms``) on a ``DeepGP``'s
output, its likelihood term averaged over the sample dimension (dim 0) and the KL terms of
every layer (``DeepGP.deep_kl_divergence``).  ``DeepPredictiveLogLikelihood`` is the
objective of deep sigma point processes (``models/deep_gps/dspp.py``)."""

from __future__ import annotations

import torch

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


class DeepPredictiveLogLikelihood(MarginalLogLikelihood):
    """Σ_i log Σ_s w_s p(y_i | x_i, site s) / (minibatch size) − β·KL / num_data: the
    likelihood's log marginal at each of the Q sites (the output's leading dimension),
    mixed by the model's learned ``quad_weights`` (log w_s) with a logsumexp."""

    def __init__(self, likelihood, model, num_data: int, beta: float = 1.0):
        super().__init__(likelihood, model)
        self.num_data = int(num_data)
        self.beta = float(beta)

    def forward(self, approximate_dist_f, target, **kwargs):
        base_log_marginal = self.likelihood.log_marginal(target, approximate_dist_f, **kwargs)  # (Q, ..., n)
        log_w = self.model.quad_weights.reshape((-1,) + (1,) * (base_log_marginal.ndim - 1))
        ll = torch.logsumexp(log_w + base_log_marginal, dim=0).sum(-1) / approximate_dist_f.event_shape[0]
        return ll - self.model.deep_kl_divergence() * (self.beta / self.num_data)
