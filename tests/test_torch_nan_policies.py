"""The NaN policies of ``settings.observation_nan_policy`` ("mask" and "fill"): the exact MLL,
its gradients and the mean cache of the port against the JAX package, in float64 on the
CPU, from the same numpy data (15 of 300 targets NaN), raw parameters and probe base
samples; ``MaskedLinearOperator`` against the JAX one; the masked MLL against the
ordinary MLL on the observed subset; and ``optim.rhs_warm_context``.

Both branches: the dense Cholesky factor at the default settings (N=300), and mBCG (the
MLL) or preconditioned CG (the mean cache) under max_cholesky_size(0), every kernel block
lazy.  Probes are injected by shape into the JAX package by replacing both
``probe_base_samples`` it calls (``linop.base``: N(0, I) probes, which the masked operator
takes, having no preconditioner; ``linop.root``: N(0, P) probes) and into the port through
``base_samples``.
"""

import contextlib
import functools
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu.linop.base
import gpytorch_tpu.linop.root
import gpytorch_tpu_torch as gt
from gpytorch_tpu.models import ExactGP as JaxExactGP

N, M, D, PROBES = 300, 20, 3, 8
PARAMS = {
    "covar_module.base_kernel.raw_lengthscale": np.array([[-1.0, -0.5, -1.2]]),
    "covar_module.raw_outputscale": np.array(0.3),
    "likelihood.noise_covar.raw_noise": np.array([0.0]),
    "mean_module.raw_constant": np.array(0.05),
}
# The same arithmetic in another order.  The noise is large enough (0.69) for the masked
# operator's unpreconditioned CG to converge at tolerance 1e-11 in both packages: at 0.2
# neither converges within its 2N + 10 iterations, and the two iterations drift 1e-6 apart.
RTOL = 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _task(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(N + M, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * np.sin(7 * x[:, 2] * x[:, 0]) + 0.1 * rng.normal(size=N + M)
    y = (y - y.mean()) / y.std()
    y[rng.choice(N, size=15, replace=False)] = np.nan
    return x[:N], y[:N], x[N:]


def _draw(shape):
    return np.random.default_rng([5, *shape]).normal(size=shape)


class JaxModel(JaxExactGP):
    def __init__(self, x, y, likelihood):
        super().__init__(x, y, likelihood)
        self.mean_module = gp.means.ConstantMean()
        self.covar_module = gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=D))

    def forward(self, x):
        return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


class TorchModel(gt.models.ExactGP):
    def __init__(self, x, y, likelihood):
        super().__init__(x, y, likelihood)
        self.mean_module = gt.means.ConstantMean()
        self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D))

    def forward(self, x):
        return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


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
    for module in (gpytorch_tpu.linop.base, gpytorch_tpu.linop.root):
        monkeypatch.setattr(module, "probe_base_samples", lambda key, shape, dtype: jnp.asarray(_draw(tuple(shape)), dtype))


def _settings(mod, branch, policy):
    stack = contextlib.ExitStack()
    ctxs = [mod.observation_nan_policy(policy), mod.cg_stall_window(50), mod.eval_cg_tolerance(1e-11)]
    if branch == "cg":
        ctxs += [mod.max_cholesky_size(0), mod.min_preconditioning_size(0), mod.max_preconditioner_size(50),
                 mod.preconditioner_noise_budget(1e-3), mod.max_eager_kernel_size(16), mod.num_trace_samples(PROBES),
                 mod.cg_tolerance(1e-11), mod.max_lanczos_quadrature_iterations(40)]
    for ctx in ctxs:
        stack.enter_context(ctx)
    return stack


def _torch_model(x, y):
    tm = TorchModel(torch.from_numpy(x), torch.from_numpy(y), gt.likelihoods.GaussianLikelihood()).double()
    return gt.load_jax_params(tm, PARAMS)


@functools.lru_cache(maxsize=None)
def _jax_results(branch, policy):
    """The JAX package's MLL and its gradient over the raw parameters, the mean cache and
    the predictive mean at the test points."""
    x, y, test_x = _task()

    def mll(p):
        m = JaxModel(jnp.asarray(x), jnp.asarray(y), gp.likelihoods.GaussianLikelihood()).with_params(p)
        return gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(jnp.asarray(x)), jnp.asarray(y),
                                                                     key=jax.random.PRNGKey(0))

    def serve(p):
        m = JaxModel(jnp.asarray(x), jnp.asarray(y), gp.likelihoods.GaussianLikelihood()).with_params(p).eval()
        mean = m(jnp.asarray(test_x)).mean
        return m._cache["prediction_strategy"].mean_cache, mean

    params = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    with _settings(gp.settings, branch, policy):
        value, grad = jax.jit(jax.value_and_grad(mll))(params)
        cache, mean = jax.jit(serve)(params)
    return float(value), {k: np.asarray(v) for k, v in grad.items()}, np.asarray(cache), np.asarray(mean)


@pytest.mark.parametrize("branch", ["cholesky", "cg"])
@pytest.mark.parametrize("policy", ["mask", "fill"])
def test_mll_matches_jax_package(policy, branch):
    x, y, _ = _task()
    want_v, want_g, _, _ = _jax_results(branch, policy)
    tm = _torch_model(x, y).train()
    with _settings(gt.settings, branch, policy):
        value = gt.mlls.ExactMarginalLogLikelihood(tm.likelihood, tm)(tm(tm.train_inputs[0]), tm.train_targets,
                                                                     base_samples=_draw)
    value.backward()
    assert math.isfinite(value.item())
    np.testing.assert_allclose(value.item(), want_v, rtol=RTOL)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name], rtol=RTOL, atol=RTOL * np.abs(want_g[name]).max(),
                                   err_msg=name)


@pytest.mark.parametrize("branch", ["cholesky", "cg"])
@pytest.mark.parametrize("policy", ["mask", "fill"])
def test_mean_cache_matches_jax_package(policy, branch):
    x, y, test_x = _task()
    _, _, want_cache, want_mean = _jax_results(branch, policy)
    tm = _torch_model(x, y).eval()
    with _settings(gt.settings, branch, policy), torch.no_grad():
        mean = tm(torch.from_numpy(test_x)).mean.numpy()
        cache = tm.prediction_strategy().mean_cache.numpy()
    assert np.isfinite(cache).all() and np.isfinite(mean).all()
    np.testing.assert_allclose(cache, want_cache, rtol=0, atol=RTOL * np.abs(want_cache).max())
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=RTOL * np.abs(want_mean).max())
    if policy == "mask":
        # the masked entries' solve is zero: the cache is that of the observed subset
        assert (cache[np.isnan(y)] == 0.0).all()


def test_masked_operator_matches_jax_package():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(40, 40))
    K, mask, v = a @ a.T, rng.uniform(size=40) > 0.2, rng.normal(size=(40, 3))
    jop = gp.linop.MaskedLinearOperator(gp.linop.DenseLinearOperator(jnp.asarray(K)), jnp.asarray(mask))
    top = gt.linop.MaskedLinearOperator(gt.linop.DenseLinearOperator(torch.from_numpy(K)), torch.from_numpy(mask))
    np.testing.assert_array_equal(top.to_dense().numpy(), np.asarray(jop.to_dense()))
    np.testing.assert_allclose(top._diagonal().numpy(), np.asarray(jop._diagonal()), rtol=1e-15)
    np.testing.assert_allclose(top.matmul(torch.from_numpy(v)).numpy(), np.asarray(jop.matmul(jnp.asarray(v))),
                               rtol=1e-12)
    assert top._preconditioner() == (None, None, None)
    # flattened with the mask as a tensor that carries no gradient, and rebuilt
    tensors, rebuild = top._flatten()
    assert tensors[-1].dtype == torch.bool and torch.equal(rebuild(tensors).to_dense(), top.to_dense())


@pytest.mark.parametrize("branch", ["cholesky", "cg"])
def test_masked_mll_is_the_observed_subsets(branch):
    # "mask" is the MLL of the observed points (with ½ log 2π for each masked one taken out,
    # as in the JAX package), divided by all N.  On the mBCG branch the subset's probes are
    # the masked run's restricted to the observed rows, whose masked rows are scaled so that
    # each probe's squared norm per row is the same over the observed rows as over all:
    # SLQ then estimates the same quantity from the same Krylov spaces, but for the masked
    # operator's unit eigenvalue.  Tolerance: 1e-12 of |MLL| on the Cholesky branch, and
    # 1e-6 on the mBCG branch (40 Lanczos steps of quadrature).
    x, y, _ = _task()
    observed = ~np.isnan(y)
    n_obs = observed.sum()
    tm = _torch_model(x, y).train()
    sub = _torch_model(x[observed], y[observed]).train()
    draws = {}

    def masked_draw(shape):
        z = _draw(shape)
        ratio = (z[observed] ** 2).sum(0) * (N - n_obs) / (n_obs * (z[~observed] ** 2).sum(0))
        z[~observed] *= np.sqrt(ratio)
        draws[shape] = z
        return z

    with _settings(gt.settings, branch, "mask"), gt.settings.max_preconditioner_size(0), torch.no_grad():
        masked = gt.mlls.ExactMarginalLogLikelihood(tm.likelihood, tm)(tm(tm.train_inputs[0]), tm.train_targets,
                                                                      base_samples=masked_draw) * N
        with gt.settings.observation_nan_policy("ignore"):
            subset = gt.mlls.ExactMarginalLogLikelihood(sub.likelihood, sub)(
                sub(sub.train_inputs[0]), sub.train_targets,
                base_samples=lambda shape: draws[(N,) + tuple(shape[1:])][observed]) * n_obs
    if branch == "cholesky":
        # the jitter ε = 1e-8 that the dense factor adds: n_masked · log(1 + ε) in log|K̃|
        subset = subset - 0.5 * (N - n_obs) * math.log1p(1e-8)
    np.testing.assert_allclose(masked.item(), subset.item(), rtol=1e-12 if branch == "cholesky" else 1e-6)


def test_ignore_keeps_nan_and_warm_start_raises_under_the_policies():
    x, y, _ = _task()
    tm = _torch_model(x, y).train()
    mll = gt.mlls.ExactMarginalLogLikelihood(tm.likelihood, tm)
    with torch.no_grad():
        assert math.isnan(mll(tm(tm.train_inputs[0]), tm.train_targets).item())
        for policy in ("mask", "fill"):
            with gt.settings.observation_nan_policy(policy), pytest.raises(ValueError, match="ignore"):
                mll(tm(tm.train_inputs[0]), tm.train_targets, solver_state=torch.zeros(N, 1), return_state=True)
        with gt.settings.observation_nan_policy("drop"), pytest.raises(ValueError, match="drop"):
            mll(tm(tm.train_inputs[0]), tm.train_targets)


def test_rhs_warm_context_sets_the_recipe():
    from gpytorch_tpu.optim.warm_start import rhs_warm_context as jax_rhs_warm_context

    for probe_iters in (10, 6):
        with gt.optim.rhs_warm_context(probe_iters), jax_rhs_warm_context(probe_iters):
            for name in ("precond_logdet_vr", "max_lanczos_quadrature_iterations"):
                got, want = getattr(gt.settings, name), getattr(gp.settings, name)
                assert (got.value() if hasattr(got, "value") else got.on()) == \
                       (want.value() if hasattr(want, "value") else want.on())
            assert gt.settings.max_lanczos_quadrature_iterations.value() == probe_iters
            assert gt.settings.precond_logdet_vr.on()
    assert gt.settings.precond_logdet_vr.off() and gt.settings.max_lanczos_quadrature_iterations.value() == 20
