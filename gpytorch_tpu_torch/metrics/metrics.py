"""Metrics on predictive distributions.  Counterpart of ``mean_squared_error`` and
``negative_log_predictive_density`` in ``gpytorch_tpu/metrics/metrics.py``."""

from __future__ import annotations

import math

import torch

from ..distributions import MultivariateNormal


def mean_squared_error(pred_dist: MultivariateNormal, test_y: torch.Tensor, squared: bool = True) -> torch.Tensor:
    res = ((pred_dist.mean - test_y) ** 2).mean(-1)
    return res if squared else res.sqrt()


def negative_log_predictive_density(pred_dist: MultivariateNormal, test_y: torch.Tensor, eig_floor=None) -> torch.Tensor:
    """−log p(y*) / n under the joint predictive distribution.

    Without ``eig_floor``, ``−pred_dist.log_prob(test_y) / n`` as the JAX package computes
    it: a dense Cholesky factor with escalating jitter up to ``max_cholesky_size`` test
    points, mBCG with stochastic Lanczos quadrature above.  With ``eig_floor`` (e.g. the
    likelihood noise, a provable lower bound of the predictive spectrum), from a symmetric
    eigendecomposition of the dense covariance whose eigenvalues are clamped there, which
    removes the spurious negative eigenvalues that solver and LOVE-truncation error leave in
    a covariance formed by subtraction."""
    n = pred_dist.event_shape[0]
    if eig_floor is None:
        return -pred_dist.log_prob(test_y) / n
    cov = pred_dist.covariance_matrix
    w, V = torch.linalg.eigh(0.5 * (cov + cov.mT))
    w = torch.clamp_min(w, eig_floor) if not torch.is_tensor(eig_floor) else torch.maximum(w, eig_floor)
    proj = V.mT @ (test_y - pred_dist.mean).unsqueeze(-1)
    quad = (proj.squeeze(-1) ** 2 / w).sum(-1)
    lp = -0.5 * (quad + torch.log(w).sum(-1) + n * math.log(2 * math.pi))
    return -lp / n
