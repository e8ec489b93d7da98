"""Metrics on predictive distributions.  Counterpart of ``gpytorch_tpu/metrics/metrics.py``:
mean absolute and (standardised) mean squared error, the NLPD, the mean standardised log loss
and the quantile coverage error.  A ``MultitaskMultivariateNormal``'s points and tasks are one
axis (``_combine_dims``), as in the JAX package.  Variances of targets divide by n
(``correction=0``), as ``jnp.var`` does."""

from __future__ import annotations

import math

import torch

from ..distributions import MultitaskMultivariateNormal, MultivariateNormal


def _combine_dims(pred_dist: MultivariateNormal, arr: torch.Tensor) -> torch.Tensor:
    if isinstance(pred_dist, MultitaskMultivariateNormal):
        return arr.reshape(arr.shape[: -len(pred_dist.event_shape)] + (-1,))
    return arr


def mean_absolute_error(pred_dist: MultivariateNormal, test_y: torch.Tensor) -> torch.Tensor:
    return _combine_dims(pred_dist, (pred_dist.mean - test_y).abs()).mean(-1)


def mean_squared_error(pred_dist: MultivariateNormal, test_y: torch.Tensor, squared: bool = True) -> torch.Tensor:
    res = _combine_dims(pred_dist, (pred_dist.mean - test_y) ** 2).mean(-1)
    return res if squared else res.sqrt()


def standardized_mean_squared_error(pred_dist: MultivariateNormal, test_y: torch.Tensor) -> torch.Tensor:
    """The MSE over the targets' variance."""
    return mean_squared_error(pred_dist, test_y) / _combine_dims(pred_dist, test_y).var(-1, correction=0)


def negative_log_predictive_density(pred_dist: MultivariateNormal, test_y: torch.Tensor, eig_floor=None) -> torch.Tensor:
    """−log p(y*) / n under the joint predictive distribution, n the number of values.

    Without ``eig_floor``, ``−pred_dist.log_prob(test_y) / n`` as the JAX package computes
    it: a dense Cholesky factor with escalating jitter up to ``max_cholesky_size`` test
    points, mBCG with stochastic Lanczos quadrature above.  With ``eig_floor`` (e.g. the
    likelihood noise, a provable lower bound of the predictive spectrum), from a symmetric
    eigendecomposition of the dense covariance whose eigenvalues are clamped there, which
    removes the spurious negative eigenvalues that solver and LOVE-truncation error leave in
    a covariance formed by subtraction."""
    n = math.prod(pred_dist.event_shape)
    if eig_floor is None:
        return -pred_dist.log_prob(test_y) / n
    cov = pred_dist.covariance_matrix
    w, V = torch.linalg.eigh(0.5 * (cov + cov.mT))
    w = torch.clamp_min(w, eig_floor) if not torch.is_tensor(eig_floor) else torch.maximum(w, eig_floor)
    proj = V.mT @ _combine_dims(pred_dist, test_y - pred_dist.mean).unsqueeze(-1)
    quad = (proj.squeeze(-1) ** 2 / w).sum(-1)
    lp = -0.5 * (quad + torch.log(w).sum(-1) + n * math.log(2 * math.pi))
    return -lp / n


def mean_standardized_log_loss(pred_dist: MultivariateNormal, test_y: torch.Tensor, train_y=None) -> torch.Tensor:
    """The mean of −log N(y*; μ, σ²) over the values; with ``train_y``, less that of the
    trivial model N(mean(train_y), var(train_y))."""
    mean, var = pred_dist.mean, pred_dist.variance
    res = _combine_dims(pred_dist, 0.5 * torch.log(2 * math.pi * var) + (test_y - mean) ** 2 / (2 * var)).mean(-1)
    if train_y is not None:
        train_mean = train_y.mean(-1, keepdim=True)
        train_var = train_y.var(-1, keepdim=True, correction=0)
        trivial = 0.5 * torch.log(2 * math.pi * train_var) + (test_y - train_mean) ** 2 / (2 * train_var)
        res = res - _combine_dims(pred_dist, trivial).mean(-1)
    return res


def quantile_coverage_error(pred_dist: MultivariateNormal, test_y: torch.Tensor,
                            quantile: float = 95.0) -> torch.Tensor:
    """|the share of values inside the central ``quantile`` % interval − quantile / 100|."""
    if not 0 < quantile < 100:
        raise NotImplementedError("quantile must be in (0, 100)")
    z = torch.special.erfinv(torch.tensor(quantile / 100.0, dtype=torch.float64)).item() * math.sqrt(2.0)
    deviation = z * pred_dist.stddev
    lower, upper = pred_dist.mean - deviation, pred_dist.mean + deviation
    covered = ((test_y > lower) & (test_y < upper)).to(test_y.dtype)
    return (_combine_dims(pred_dist, covered).mean(-1) - quantile / 100.0).abs()
