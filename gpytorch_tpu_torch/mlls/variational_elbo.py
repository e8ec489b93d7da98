"""``VariationalELBO`` and ``GammaRobustVariationalELBO``.  Counterpart of
``gpytorch_tpu/mlls/variational_elbo.py``."""

from __future__ import annotations

import math

import torch

from ._approximate_mll import _ApproximateMarginalLogLikelihood


def _sum_event(lp: torch.Tensor, dist) -> torch.Tensor:
    n_event = max(len(dist.event_shape), 1)
    return lp.sum(dim=tuple(range(-n_event, 0)))


class VariationalELBO(_ApproximateMarginalLogLikelihood):
    """The SVGP evidence lower bound: the likelihood term is Σ E_q[log p(y | f)]."""

    def _log_likelihood_term(self, variational_dist_f, target, **kwargs):
        return _sum_event(self.likelihood.expected_log_prob(target, variational_dist_f, **kwargs), variational_dist_f)


class GammaRobustVariationalELBO(_ApproximateMarginalLogLikelihood):
    """The γ-divergence bound (γ > 1), robust to outliers; its likelihood term
    Σ γ/(γ − 1) E_q[p(y | f)^(γ−1)] is a closed form for a Gaussian likelihood."""

    def __init__(self, likelihood, model, gamma: float = 1.03, **kwargs):
        if gamma <= 1.0:
            raise ValueError("gamma should be > 1.0")
        super().__init__(likelihood, model, **kwargs)
        self.gamma = float(gamma)

    def _log_likelihood_term(self, variational_dist_f, target, **kwargs):
        shifted_gamma = self.gamma - 1.0
        muf, varf = variational_dist_f.mean, variational_dist_f.variance
        noise = self.likelihood._noise_diag(muf.shape)
        mut = shifted_gamma * target / noise + muf / varf
        sigmat = 1.0 / (shifted_gamma / noise + 1.0 / varf)
        log_tempered = (-math.log(shifted_gamma) - 0.5 * shifted_gamma * torch.log(2 * math.pi * noise)
                        - 0.5 * torch.log1p(shifted_gamma * varf / noise) - 0.5 * (shifted_gamma * target ** 2 / noise)
                        - 0.5 * (muf ** 2 / varf) + 0.5 * (mut ** 2 * sigmat))
        return (torch.exp(log_tempered) * (self.gamma / shifted_gamma)).sum(-1)
