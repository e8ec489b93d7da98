"""The port's spectral-mixture exact GP against the JAX package, in float64 on the CPU.

The model of GPyTorch's spectral-mixture tutorial on a time series: ConstantMean,
SpectralMixtureKernel(num_mixtures=4) initialised by ``initialize_from_data``, and
GaussianLikelihood, on ``chip_smoke.make_periodic_task``'s 5-minute readings (its time
column, in days) at N=600.  Under ``max_eager_kernel_size(64)`` every product with K streams
by blocks of 128 rows in both packages (``_matmul_chunked``; the JAX package's
``jax.lax.map`` over its blocks), and the rank-20 pivoted-Cholesky preconditioner reads the
lazy operator's rows: the MLL and its gradient in every raw parameter with the same injected
probes, then the posterior mean of the next 96 readings.

Tolerance 1e-8 relative, as the exact-GP training parity: both packages run the same float64
arithmetic in another order through CG.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu.linop.base
import gpytorch_tpu.linop.lazy_kernel
import gpytorch_tpu.linop.root
import gpytorch_tpu_torch as gt
from gpytorch_tpu_torch.linop import lazy_kernel

N, N_TEST, Q = 600, 96, 4
RTOL = 1e-8
F64 = jnp.float64


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _draw(shape):
    return np.random.default_rng([9, *shape]).normal(size=shape)


def _jax_draw(key, shape, dtype):
    return jnp.asarray(_draw(tuple(shape)), dtype=dtype)


@pytest.fixture(autouse=True)
def blocks_and_probes(monkeypatch):
    """Blocks of 128 rows in both packages, and the probes injected into the JAX side."""
    monkeypatch.setattr(lazy_kernel, "_CHUNK", 128)
    monkeypatch.setattr(gpytorch_tpu.linop.lazy_kernel, "_CHUNK", 128)
    monkeypatch.setattr(gpytorch_tpu.linop.base, "probe_base_samples", _jax_draw)
    monkeypatch.setattr(gpytorch_tpu.linop.root, "probe_base_samples", _jax_draw)


def _task():
    """make_periodic_task's readings (chip_smoke.py): a daily profile with two peaks, damped at
    weekends, noise 0.1·std(f), standardised; the time column alone."""
    rng = np.random.default_rng(0)
    t = np.arange(N + N_TEST) / 288.0
    h = 24.0 * (t - np.floor(t))
    f = np.exp(-(((h - 8.0) / 1.5) ** 2)) + 0.8 * np.exp(-(((h - 17.5) / 2.0) ** 2))
    f = np.where(np.floor(t) % 7 >= 5, 0.4 * f, f)
    y = f + 0.1 * f.std() * rng.normal(size=t.shape)
    y = (y - y.mean()) / y.std()
    return t[:N, None], y[:N], t[N:, None]


def _model(pkg, x, y, f64):
    class SpectralMixtureGP(pkg.models.ExactGP):
        def __init__(self, tx, ty, likelihood):
            super().__init__(tx, ty, likelihood)
            self.mean_module = pkg.means.ConstantMean(**f64)
            self.covar_module = pkg.kernels.SpectralMixtureKernel(num_mixtures=Q, **f64)

        def forward(self, z):
            return pkg.distributions.MultivariateNormal(self.mean_module(z), self.covar_module(z))

    return SpectralMixtureGP(x, y, pkg.likelihoods.GaussianLikelihood(**f64))


def _settings(mod):
    stack = contextlib.ExitStack()
    for ctx in (mod.max_eager_kernel_size(64), mod.max_cholesky_size(0), mod.min_preconditioning_size(0),
                mod.max_preconditioner_size(20), mod.max_cg_iterations(1000), mod.cg_tolerance(1e-10),
                mod.eval_cg_tolerance(1e-10), mod.num_trace_samples(8), mod.max_lanczos_quadrature_iterations(30)):
        stack.enter_context(ctx)
    return stack


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """The JAX model initialised from the data: its raw parameters, −MLL, the gradient and the
    posterior mean of the test readings."""
    x, y, xs = _task()
    jm = _model(gp, jnp.asarray(x), jnp.asarray(y), {"dtype": F64})
    jm.covar_module.initialize_from_data(x, y)
    params = {k: np.asarray(v, dtype=np.float64) for k, v in jm.trainable_params().items()}

    def loss(p):
        m = jm.with_params(p)
        with _settings(gp.settings):
            return -gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(jnp.asarray(x)), jnp.asarray(y),
                                                                         key=jax.random.PRNGKey(0))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    value, grad = jax.jit(jax.value_and_grad(loss))(jp)
    with _settings(gp.settings):
        mean = jm.with_params(jp).eval()(jnp.asarray(xs)).mean
    return params, float(value), {k: np.asarray(g) for k, g in grad.items()}, np.asarray(mean)


def _torch_model():
    x, y, _ = _task()
    model = _model(gt, torch.from_numpy(x), torch.from_numpy(y), {}).double()
    model.covar_module.initialize_from_data(model.train_inputs[0], model.train_targets)
    return model


def test_initialised_parameters_match_jax_package():
    # initialize_from_data on the same readings: the same raw parameters; 1e-12
    params, *_ = _jax_reference()
    got = dict(_torch_model().named_parameters())
    assert set(got) == set(params)
    for name, want in params.items():
        np.testing.assert_allclose(got[name].detach().numpy(), want, rtol=1e-12, atol=1e-12, err_msg=name)


def test_mll_gradient_and_forecast_through_blocks_match_jax_package():
    params, want, want_grad, want_mean = _jax_reference()
    _, _, xs = _task()
    model = _torch_model()
    with _settings(gt.settings):
        op = model(model.train_inputs[0]).lazy_covariance_matrix
        assert isinstance(op, gt.linop.LazyEvaluatedKernelOperator) and op._is_big()
        loss = -gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)(model(model.train_inputs[0]),
                                                                             model.train_targets, base_samples=_draw)
        loss.backward()
        np.testing.assert_allclose(loss.item(), want, rtol=RTOL)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want_grad[name], rtol=RTOL,
                                       atol=RTOL * np.abs(want_grad[name]).max(), err_msg=name)
        model.eval()
        with torch.no_grad():
            mean = model(torch.from_numpy(xs)).mean
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=0, atol=RTOL * np.abs(want_mean).max())
