"""The port's metrics (``gpytorch_tpu_torch/metrics``) against the JAX package, in float64 on
the CPU: the mean absolute error, the (standardised) mean squared error, the mean standardised
log loss with and without the training targets' trivial model, the 95 % (and 50 %) quantile
coverage error and the NLPD, on a ``MultivariateNormal`` and on an interleaved
``MultitaskMultivariateNormal`` (points and tasks one axis, ``_combine_dims``).  The targets'
variances divide by n in both packages (``jnp.var``; ``torch.var`` takes ``correction=0``).

Tolerance: 1e-12 relative (the same closed forms); the NLPD by dense Cholesky 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt

N, T = 40, 3
RTOL = 1e-12
METRICS = ["mean_absolute_error", "mean_squared_error", "standardized_mean_squared_error",
           "mean_standardized_log_loss", "quantile_coverage_error"]


def _case(multitask, seed=0):
    rng = np.random.default_rng(seed)
    shape = (N, T) if multitask else (N,)
    size = int(np.prod(shape))
    A = rng.normal(size=(size, size))
    cov = 0.05 * A @ A.T / size + np.diag(rng.uniform(0.05, 0.3, size=size))
    mean = rng.normal(size=shape)
    y = mean + rng.normal(size=shape) * np.sqrt(np.diag(cov)).reshape(shape) * 1.3
    train_y = 0.5 + 2.0 * rng.normal(size=80)
    return mean, cov, y, train_y


def _dists(multitask, mean, cov):
    if multitask:
        return (gp.distributions.MultitaskMultivariateNormal(jnp.asarray(mean), jnp.asarray(cov)),
                gt.distributions.MultitaskMultivariateNormal(torch.from_numpy(mean), torch.from_numpy(cov)))
    return (gp.distributions.MultivariateNormal(jnp.asarray(mean), jnp.asarray(cov)),
            gt.distributions.MultivariateNormal(torch.from_numpy(mean), torch.from_numpy(cov)))


@pytest.mark.parametrize("multitask", [False, True], ids=["mvn", "multitask"])
@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_jax(name, multitask):
    mean, cov, y, train_y = _case(multitask)
    jd, td = _dists(multitask, mean, cov)
    want = np.asarray(getattr(gp.metrics, name)(jd, jnp.asarray(y)))
    got = getattr(gt.metrics, name)(td, torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == ()
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("multitask", [False, True], ids=["mvn", "multitask"])
def test_msll_with_train_y_and_other_options_match_jax(multitask):
    mean, cov, y, train_y = _case(multitask, seed=1)
    jd, td = _dists(multitask, mean, cov)
    ty, jy = torch.from_numpy(y), jnp.asarray(y)
    pairs = [
        (gt.metrics.quantile_coverage_error(td, ty, quantile=50.0), gp.metrics.quantile_coverage_error(jd, jy, 50.0)),
        (gt.metrics.mean_squared_error(td, ty, squared=False), gp.metrics.mean_squared_error(jd, jy, squared=False)),
    ]
    if not multitask:  # both packages average a multitask train_y over its last axis, the tasks
        pairs.append((gt.metrics.mean_standardized_log_loss(td, ty, torch.from_numpy(train_y)),
                      gp.metrics.mean_standardized_log_loss(jd, jy, jnp.asarray(train_y))))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(gt.metrics.negative_log_predictive_density(td, ty).numpy(),
                               np.asarray(gp.metrics.negative_log_predictive_density(jd, jy)), rtol=1e-10)
    floor = 0.1
    np.testing.assert_allclose(gt.metrics.negative_log_predictive_density(td, ty, eig_floor=floor).numpy(),
                               np.asarray(gp.metrics.negative_log_predictive_density(jd, jy, eig_floor=floor)),
                               rtol=1e-10)


def test_trivial_model_divides_by_n():
    # the trivial model's variance and SMSE's divide by n (jnp.var's), not by torch.var's
    # default n − 1
    mean, cov, y, train_y = _case(False, seed=2)
    _, td = _dists(False, mean, cov)
    got = gt.metrics.mean_standardized_log_loss(td, torch.from_numpy(y), torch.from_numpy(train_y)).item()
    own = gt.metrics.mean_standardized_log_loss(td, torch.from_numpy(y)).item()
    m, v = train_y.mean(), train_y.var()
    trivial = np.mean(0.5 * np.log(2 * np.pi * v) + (y - m) ** 2 / (2 * v))
    np.testing.assert_allclose(got, own - trivial, rtol=RTOL)
    smse = gt.metrics.standardized_mean_squared_error(td, torch.from_numpy(y)).item()
    np.testing.assert_allclose(smse, np.mean((mean - y) ** 2) / y.var(), rtol=RTOL)
    with pytest.raises(NotImplementedError):
        gt.metrics.quantile_coverage_error(td, torch.from_numpy(y), quantile=100.0)


def test_batched_metrics_keep_the_batch():
    rng = np.random.default_rng(3)
    mean, y = rng.normal(size=(2, N)), rng.normal(size=(2, N))
    cov = np.broadcast_to(np.eye(N) * 0.3, (2, N, N)).copy()
    jd = gp.distributions.MultivariateNormal(jnp.asarray(mean), jnp.asarray(cov))
    td = gt.distributions.MultivariateNormal(torch.from_numpy(mean), torch.from_numpy(cov))
    for name in METRICS:
        got = getattr(gt.metrics, name)(td, torch.from_numpy(y)).numpy()
        assert got.shape == (2,)
        np.testing.assert_allclose(got, np.asarray(getattr(gp.metrics, name)(jd, jnp.asarray(y))), rtol=RTOL)
