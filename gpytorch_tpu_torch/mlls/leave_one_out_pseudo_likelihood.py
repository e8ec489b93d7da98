"""The leave-one-out pseudo-likelihood.  Counterpart of
``gpytorch_tpu/mlls/leave_one_out_pseudo_likelihood.py``: Σᵢ log N(yᵢ; μᵢ, σᵢ²) of each point
under the posterior of the others (Rasmussen and Williams §5.4.2), in closed form from one
Cholesky factor L of the dense K̂ = K + σ²I:

    σᵢ² = 1 / [K̂⁻¹]ᵢᵢ = 1 / Σ_k (L⁻¹)²_kᵢ,    μᵢ = yᵢ − [K̂⁻¹(y − m)]ᵢ σᵢ²,

plus the added loss terms and the priors (each once, as ``ExactMarginalLogLikelihood``), over
n.  ``psd_safe_cholesky`` factors in float64 and returns the input's dtype, so a float32 model
takes σᵢ² from a float32 L⁻¹.  K̂, L and L⁻¹ are n × n: this objective is for small n."""

from __future__ import annotations

import math

import torch

from ..solvers.cholesky import psd_safe_cholesky
from .exact_marginal_log_likelihood import ExactMarginalLogLikelihood


def _loo_moments(output, target):
    """(μᵢ, σᵢ²) of every point under the others, from the marginal ``output`` over the targets."""
    L = psd_safe_cholesky(output.lazy_covariance_matrix.evaluate_kernel().to_dense())
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    sigma2 = 1.0 / torch.linalg.solve_triangular(L, eye, upper=False).pow(2).sum(-2)
    solve = torch.cholesky_solve((target - output.mean).unsqueeze(-1), L).squeeze(-1)
    return target - solve * sigma2, sigma2


class LeaveOneOutPseudoLikelihood(ExactMarginalLogLikelihood):
    def forward(self, function_dist, target, *params):
        mu, sigma2 = _loo_moments(self.likelihood(function_dist, *params), target)
        res = (-0.5 * (torch.log(2 * math.pi * sigma2) + (target - mu) ** 2 / sigma2)).sum(-1)
        return self._add_other_terms(res, params) / target.shape[-1]
