"""The variational objectives' common form.  Counterpart of
``gpytorch_tpu/mlls/_approximate_mll.py``:

    (likelihood term) / (minibatch size) − β·KL(q(u) ‖ p(u)) / num_data
        + (log-density of the model's priors) / num_data − (added loss terms),

or with ``combine_terms=False`` the tuple (likelihood term, KL term, prior term), and the
added loss terms fourth where the model has any.  A ``kl_indices=`` keyword goes to the
strategy's ``kl_divergence`` (VNNGP's stochastic KL), not to the likelihood."""

from __future__ import annotations

import torch

from .marginal_log_likelihood import MarginalLogLikelihood


class _ApproximateMarginalLogLikelihood(MarginalLogLikelihood):
    def __init__(self, likelihood, model, num_data: int, beta: float = 1.0, combine_terms: bool = True):
        super().__init__(likelihood, model)
        self.num_data = int(num_data)
        self.beta = float(beta)
        self.combine_terms = bool(combine_terms)

    def _log_likelihood_term(self, approximate_dist_f, target, **kwargs) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, approximate_dist_f, target, **kwargs):
        num_batch = approximate_dist_f.event_shape[0]
        # ``kl_indices``: the minibatch of a VNNGP's stochastic KL, for the strategy alone
        kl_kwargs = {"kl_indices": kwargs.pop("kl_indices")} if "kl_indices" in kwargs else {}
        log_likelihood = self._log_likelihood_term(approximate_dist_f, target, **kwargs) / num_batch
        kl_divergence = self.model.variational_strategy.kl_divergence(model=self.model, **kl_kwargs) * (
            self.beta / self.num_data)
        log_prior = self.model.prior_log_prob_sum()
        log_prior = torch.zeros_like(kl_divergence) if log_prior is None else log_prior / self.num_data
        added_loss, had_added_loss = torch.zeros_like(kl_divergence), False
        for term in self.model.added_loss_terms():
            added_loss, had_added_loss = added_loss + term.loss(), True
        if self.combine_terms:
            return log_likelihood - kl_divergence + log_prior - added_loss
        if had_added_loss:
            return log_likelihood, kl_divergence, log_prior, added_loss
        return log_likelihood, kl_divergence, log_prior
