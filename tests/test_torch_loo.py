"""The port's ``LeaveOneOutPseudoLikelihood`` against the JAX package and against brute-force
leave-one-out, in float64 on the CPU.

The flagship's model (ConstantMean, ScaleKernel(RBF-ARD, d=3), GaussianLikelihood with a
LogNormal(−4, 1) noise prior) on the same numpy data and raw parameters in both packages,
the JAX package's float32 distance product swapped for a float64 one.  Both packages factor
the dense K̂ + 1e-8·I (``psd_safe_cholesky``'s float64 jitter).  The JAX package adds each
likelihood prior twice (``test_torch_priors.py``); the port once, so it equals the JAX value
less one copy of the likelihood's prior term over n.

Tolerance: 1e-10 relative (the same float64 arithmetic in another order).
"""

import functools
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt

D, N_JAX, N_BRUTE = 3, 200, 50
RTOL = 1e-10
PARAMS = {
    "covar_module.base_kernel.raw_lengthscale": np.array([[-0.4, 0.1, -0.7]]),
    "covar_module.raw_outputscale": np.array(0.5),
    "likelihood.noise_covar.raw_noise": np.array([-3.0]),
    "mean_module.raw_constant": np.array(0.05),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _exact_float64_sq_dist(x1, x2, x1_eq_x2=False):
    adj = jnp.mean(x1, axis=-2, keepdims=True)
    x1, x2 = x1 - adj, x2 - adj
    res = (-2.0 * jnp.matmul(x1, jnp.swapaxes(x2, -1, -2), precision=jax.lax.Precision.HIGHEST)
           + jnp.sum(x1 * x1, -1, keepdims=True) + jnp.swapaxes(jnp.sum(x2 * x2, -1, keepdims=True), -1, -2))
    if x1_eq_x2:
        res = res * (1.0 - jnp.eye(res.shape[-1], dtype=res.dtype))
    return jnp.maximum(res, 0.0)


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)


def _task(n, b=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    f = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * np.sin(7 * x[:, 2] * x[:, 0])
    y = f + 0.1 * rng.normal(size=(n,) if b is None else (b, n))
    return x, (y - y.mean(-1, keepdims=True)) / y.std(-1, keepdims=True)


def _model(pkg, x, y, batch=()):
    likelihood = pkg.likelihoods.GaussianLikelihood(
        batch_shape=batch, noise_prior=pkg.priors.LogNormalPrior(np.float64(-4.0), np.float64(1.0)))

    class FlagshipGP(pkg.models.ExactGP):
        def __init__(self):
            super().__init__(x, y, likelihood)
            self.mean_module = pkg.means.ConstantMean(batch_shape=batch)
            self.covar_module = pkg.kernels.ScaleKernel(pkg.kernels.RBFKernel(ard_num_dims=D, batch_shape=batch),
                                                        batch_shape=batch)

        def forward(self, inputs):
            return pkg.distributions.MultivariateNormal(self.mean_module(inputs), self.covar_module(inputs))

    return FlagshipGP()


def _batched(shapes, seed=3):
    """PARAMS for a batch: each element's raw values moved by its own draw, in the shapes of
    the JAX model's ``trainable_params()``."""
    rng = np.random.default_rng(seed)
    return {k: np.broadcast_to(PARAMS[k].reshape(PARAMS[k].shape[-1:] if PARAMS[k].ndim else ()), shape)
            + 0.2 * rng.normal(size=shape) for k, shape in shapes.items()}


def _torch_loo(x, y, params, batch=()):
    tx = torch.from_numpy(x).expand(batch + x.shape)
    model = gt.load_jax_params(_model(gt, tx, torch.from_numpy(y), batch).double(), params)
    value = gt.mlls.LeaveOneOutPseudoLikelihood(model.likelihood, model)(model(tx), model.train_targets)
    return model, value


@functools.lru_cache(maxsize=None)
def _jax_loo(n, b=None):
    """jit(value_and_grad) of the JAX package's LOO objective (summed over a batch) and of its
    likelihood's prior term / n over the raw parameters, and the parameters' shapes."""
    x, y = _task(n, b)
    batch = () if b is None else (b,)
    jx, jy = jnp.broadcast_to(jnp.asarray(x), batch + x.shape), jnp.asarray(y)
    jm = _model(gp, jx, jy, batch)

    def loo(p):
        m = jm.with_params(p)
        value = gp.mlls.LeaveOneOutPseudoLikelihood(m.likelihood, m)(m(jx), jy)
        return jnp.sum(value), value

    def lik_prior(p):
        return jm.with_params(p).likelihood.prior_log_prob_sum() / n

    shapes = {k: np.shape(v) for k, v in jm.trainable_params().items()}
    return jax.jit(jax.value_and_grad(loo, has_aux=True)), jax.jit(jax.value_and_grad(lik_prior)), shapes


def test_loo_value_and_gradient_match_jax():
    x, y = _task(N_JAX)
    (_, jval), jgrad = _jax_loo(N_JAX)[0]({k: jnp.asarray(v) for k, v in PARAMS.items()})
    jprior, jprior_grad = _jax_loo(N_JAX)[1]({k: jnp.asarray(v) for k, v in PARAMS.items()})
    model, value = _torch_loo(x, y, PARAMS)
    value.backward()
    np.testing.assert_allclose(value.item(), float(jval) - float(jprior), rtol=RTOL)
    assert abs(float(jprior)) > 1e-3
    for name, p in model.named_parameters():
        want = np.asarray(jgrad[name]) - np.asarray(jprior_grad[name])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max(), err_msg=name)


def test_loo_matches_brute_force_conditioning():
    # each point's log density under the posterior of the other n − 1 points, from n separate
    # dense solves of K̂₋ᵢ (with the factor's 1e-8 jitter on the diagonal), plus the noise
    # prior, over n: an independent route to the closed form
    x, y = _task(N_BRUTE)
    model, value = _torch_loo(x, y, PARAMS)
    with torch.no_grad():
        prior = model(torch.from_numpy(x))
        K = (prior.covariance_matrix + model.likelihood.noise * torch.eye(N_BRUTE, dtype=torch.float64)).numpy()
        K = K + 1e-8 * np.eye(N_BRUTE)
        m = prior.mean.numpy()
        lik_prior = model.likelihood.prior_log_prob_sum().item()
    total = 0.0
    for i in range(N_BRUTE):
        rest = np.arange(N_BRUTE) != i
        w = np.linalg.solve(K[np.ix_(rest, rest)], K[rest, i])
        mu = m[i] + w @ (y[rest] - m[rest])
        var = K[i, i] - K[i, rest] @ w
        total += -0.5 * (math.log(2 * math.pi * var) + (y[i] - mu) ** 2 / var)
    np.testing.assert_allclose(value.item(), (total + lik_prior) / N_BRUTE, rtol=RTOL)


def test_batched_loo_matches_jax_per_element():
    b = 2
    x, y = _task(N_BRUTE, b)
    params = _batched(_jax_loo(N_BRUTE, b)[2])
    (_, jval), jgrad = _jax_loo(N_BRUTE, b)[0]({k: jnp.asarray(v) for k, v in params.items()})
    jprior, jprior_grad = _jax_loo(N_BRUTE, b)[1]({k: jnp.asarray(v) for k, v in params.items()})
    model, value = _torch_loo(x, y, params, (b,))
    assert value.shape == (b,)
    value.sum().backward()
    # the JAX package adds the summed prior of all elements to each element's value
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jval) - float(jprior), rtol=RTOL)
    for name, p in model.named_parameters():
        want = np.asarray(jgrad[name]) - b * np.asarray(jprior_grad[name])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max(), err_msg=name)
