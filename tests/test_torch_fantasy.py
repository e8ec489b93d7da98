"""Fantasy models (``ExactGP.get_fantasy_model``, the rank-m block-Schur update of the mean
cache) and predictions differentiated through their caches (``detach_test_caches(False)``),
the port against the JAX package in float64 on the CPU, and the rest of ``ExactGP``'s
surface: ``set_train_data``, ``prior_mode`` and the ``debug`` checks.

The flagship model of bench.py (ConstantMean + ScaleKernel(RBF-ARD, d=3) +
GaussianLikelihood) at N=200 train points, Q=5 fantasy points and M=30 test points, with
the same numpy data, raw parameters and Lanczos start blocks (keyed by their shape,
injected into both packages by replacing each one's ``_block_init``) and the JAX
package's float32 distance product swapped for a float64 one.  Both branches: the dense
Cholesky factor at the default settings, and preconditioned CG with every kernel block
lazy (the fused products' plain versions) under max_cholesky_size(0).

The JAX package's copy of the model shares its parameters' traced values; the port's
``get_fantasy_model`` deep-copies the model, whose parameters are then new leaves, so a
hyperparameter's gradient is the sum of the old model's and the copy's.
"""

import contextlib
import functools
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu.solvers.lanczos
import gpytorch_tpu_torch as gt
import gpytorch_tpu_torch.solvers.lanczos
from gpytorch_tpu.models import ExactGP as JaxExactGP
from gpytorch_tpu_torch.ops import fused_kernels as fk
from gpytorch_tpu_torch.utils.warnings import GPInputWarning

N, Q, M, D = 200, 5, 30, 3
PARAMS = {
    "covar_module.base_kernel.raw_lengthscale": np.array([[-1.0, -0.5, -1.2]]),
    "covar_module.raw_outputscale": np.array(0.3),
    "likelihood.noise_covar.raw_noise": np.array([-3.5]),
    "mean_module.raw_constant": np.array(0.05),
}
# Tolerances, relative to the largest entry: the same arithmetic in another order (the
# values read 1e-13-1e-11 on the Cholesky branch; the CG branch's solves stop on a
# tolerance of 1e-11 after the same iterations in both packages).
RTOL = 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _task(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(N + Q + M, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * np.sin(7 * x[:, 2] * x[:, 0]) + 0.1 * rng.normal(size=len(x))
    y = (y - y.mean()) / y.std()
    return x[:N], y[:N], x[N:N + Q], y[N:N + Q], x[N + Q:]


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


def _start_block(n, b):
    return np.random.default_rng([9, n, b]).normal(size=(n, b))


def _settings(mod, branch, fast_pred_var=False, detach=True):
    stack = contextlib.ExitStack()
    ctxs = [mod.fast_pred_var(fast_pred_var), mod.detach_test_caches(detach), mod.cg_tolerance(1e-11),
            mod.eval_cg_tolerance(1e-11), mod.cg_stall_window(50)]
    if branch == "cg":
        ctxs += [mod.max_cholesky_size(0), mod.min_preconditioning_size(0), mod.max_preconditioner_size(50),
                 mod.preconditioner_noise_budget(1e-3), mod.max_eager_kernel_size(16)]
    for ctx in ctxs:
        stack.enter_context(ctx)
    return stack


@pytest.fixture
def injected(monkeypatch):
    monkeypatch.setattr(gpytorch_tpu.solvers.lanczos, "_block_init",
                        lambda linop, iv, b: jnp.asarray(_start_block(linop.shape[-1], b)))
    monkeypatch.setattr(gpytorch_tpu_torch.solvers.lanczos, "_block_init",
                        lambda linop, iv, b: torch.from_numpy(_start_block(linop.shape[-1], b)))
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)


def _torch_model(x=None, y=None):
    train_x, train_y, _, _, _ = _task()
    x = train_x if x is None else x
    y = train_y if y is None else y
    tm = TorchModel(torch.from_numpy(x), torch.from_numpy(y), gt.likelihoods.GaussianLikelihood()).double()
    return gt.load_jax_params(tm, PARAMS).eval()


# -- values ------------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fantasy_values(branch, fast_pred_var):
    train_x, train_y, xf, yf, test_x = _task()

    @jax.jit
    def values(params):
        jm = JaxModel(jnp.asarray(train_x), jnp.asarray(train_y), gp.likelihoods.GaussianLikelihood())
        jm = jm.with_params(params).eval()
        with _settings(gp.settings, branch, fast_pred_var):
            jm(jnp.asarray(test_x))  # the strategy, which the fantasy model updates
            post = jm.get_fantasy_model(jnp.asarray(xf), jnp.asarray(yf))(jnp.asarray(test_x))
            return post.mean, post.variance

    return tuple(np.asarray(v) for v in values({k: jnp.asarray(v) for k, v in PARAMS.items()}))


@pytest.mark.parametrize("fast_pred_var", [False, True])
@pytest.mark.parametrize("branch", ["cholesky", "cg"])
def test_fantasy_matches_jax_package_and_a_refit(branch, fast_pred_var, injected):
    _, _, xf, yf, test_x = _task()
    want_mean, want_var = _jax_fantasy_values(branch, fast_pred_var)
    tm = _torch_model()
    tx = torch.from_numpy(test_x)
    with _settings(gt.settings, branch, fast_pred_var), torch.no_grad():
        tm(tx)
        fantasy = tm.get_fantasy_model(torch.from_numpy(xf), torch.from_numpy(yf))
        assert fantasy._cache["prediction_strategy"]._mean_cache is not None  # the Schur update, not a new solve
        post = fantasy(tx)
        mean, var = post.mean.numpy(), post.variance.numpy()
        # a refit: the same model on the n + q points, its mean cache from a new solve
        refit = _torch_model()
        refit.set_train_data(fantasy.train_inputs[0], fantasy.train_targets, strict=False)
        ref = refit(tx)
        ref_mean, ref_var = ref.mean.numpy(), ref.variance.numpy()
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=RTOL * np.abs(want_mean).max())
    np.testing.assert_allclose(var, want_var, rtol=0, atol=RTOL * np.abs(want_var).max())
    np.testing.assert_allclose(mean, ref_mean, rtol=0, atol=RTOL * np.abs(ref_mean).max())
    np.testing.assert_allclose(var, ref_var, rtol=0, atol=RTOL * np.abs(ref_var).max())
    assert fantasy.train_inputs[0].shape == (N + Q, D) and tm.train_inputs[0].shape == (N, D)
    # the copy's parameters are its own
    assert all(p is not q for p, q in zip(fantasy.parameters(), tm.parameters()))


# -- gradients through the caches ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fantasy_gradients(branch, objective):
    train_x, train_y, xf, yf, test_x = _task()

    def f(xf_, params):
        jm = JaxModel(jnp.asarray(train_x), jnp.asarray(train_y), gp.likelihoods.GaussianLikelihood())
        jm = jm.with_params(params).eval()
        jm(jnp.asarray(test_x))
        post = jm.get_fantasy_model(xf_, jnp.asarray(yf))(jnp.asarray(test_x))
        return post.mean.sum() if objective == "mean" else post.variance.sum()

    params = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    # the settings stay in force while the VJP is traced: the JAX package's solve VJP reads
    # them then (the port's backward takes the forward's)
    with _settings(gp.settings, branch, detach=False):
        value, (g_xf, g_params) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(jnp.asarray(xf), params)
    return float(value), np.asarray(g_xf), {k: np.asarray(v) for k, v in g_params.items()}


def _torch_fantasy_gradients(tm, branch, objective):
    _, _, xf, yf, test_x = _task()
    tx = torch.from_numpy(test_x)
    xf_t = torch.from_numpy(xf).requires_grad_(True)
    with _settings(gt.settings, branch, detach=False):
        fantasy = tm.get_fantasy_model(xf_t, torch.from_numpy(yf))
        post = fantasy(tx)
        value = post.mean.sum() if objective == "mean" else post.variance.sum()
    value.backward()
    own, copied = dict(tm.named_parameters()), dict(fantasy.named_parameters())
    grads = {name: sum((p.grad for p in (own[name], copied[name]) if p.grad is not None),
                       torch.zeros_like(own[name])).detach().numpy() for name in PARAMS}
    return value.item(), xf_t.grad.numpy(), grads


@pytest.mark.parametrize("objective", ["mean", "variance"])
@pytest.mark.parametrize("branch", ["cholesky", "cg"])
def test_gradient_through_the_caches_matches_jax_package(branch, objective, injected):
    # Σμ* and the exact Σσ²* of the fantasy model with respect to the fantasy inputs and
    # every hyperparameter, under detach_test_caches(False): through the old mean cache,
    # the q solves A⁻¹B, the Schur complement and the test side
    want_v, want_xf, want_p = _jax_fantasy_gradients(branch, objective)
    tm = _torch_model()
    with _settings(gt.settings, branch), torch.no_grad():
        tm(torch.from_numpy(_task()[4]))  # a strategy built under the default is not reused
    value, g_xf, g_p = _torch_fantasy_gradients(tm, branch, objective)
    np.testing.assert_allclose(value, want_v, rtol=RTOL)
    np.testing.assert_allclose(g_xf, want_xf, rtol=0, atol=RTOL * np.abs(want_xf).max())
    for name in PARAMS:
        np.testing.assert_allclose(g_p[name], want_p[name], rtol=RTOL, atol=RTOL * np.abs(want_p[name]).max(),
                                   err_msg=name)


def test_prediction_gradient_through_the_caches_matches_jax_package(injected):
    # Σμ* of the model itself with respect to its hyperparameters under
    # detach_test_caches(False) on the CG branch: the mean cache's solve differentiated
    # through the operator (replaces the parent's test that this raised)
    _, _, _, _, test_x = _task()
    train_x, train_y = _task()[:2]

    def f(params):
        jm = JaxModel(jnp.asarray(train_x), jnp.asarray(train_y), gp.likelihoods.GaussianLikelihood())
        return jm.with_params(params).eval()(jnp.asarray(test_x)).mean.sum()

    with _settings(gp.settings, "cg", detach=False):
        want = jax.jit(jax.grad(f))({k: jnp.asarray(v) for k, v in PARAMS.items()})
    tm = _torch_model()
    with _settings(gt.settings, "cg", detach=False):
        tm(torch.from_numpy(test_x)).mean.sum().backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]), rtol=RTOL, err_msg=name)


def _grads(model):
    return [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in model.parameters()]


def test_two_backward_passes_in_a_row_and_a_switch_of_settings():
    # a strategy with autograd history serves one call: a second call builds its own, so
    # two backward passes in a row both run, and read the same gradient
    _, _, xf, yf, test_x = _task()
    tm = _torch_model()
    tx = torch.from_numpy(test_x)
    grads = []
    for _ in range(2):
        tm.zero_grad()
        with _settings(gt.settings, "cg", detach=False):
            tm(tx).mean.sum().backward()
        grads.append(_grads(tm))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=0)
    # the cached strategy with history has served its one call
    assert tm._cache["prediction_strategy"].spent
    # under the default the cached strategy has no history, and the hyperparameters' gradient
    # comes from the test side alone: smaller than through the caches
    tm.zero_grad()
    with _settings(gt.settings, "cg"):
        tm(tx).mean.sum().backward()
    detached = _grads(tm)
    assert not tm._cache["prediction_strategy"].with_graph
    assert any(not torch.allclose(a, b) for a, b in zip(detached, grads[0]))
    # back to False: the cache built under the default is not reused
    tm.zero_grad()
    with _settings(gt.settings, "cg", detach=False):
        tm(tx).mean.sum().backward()
    for a, b in zip(grads[0], _grads(tm)):
        torch.testing.assert_close(b, a, rtol=1e-10, atol=0)
    # a fantasy model twice in a row, then a default call on the fantasy model
    xf_t = torch.from_numpy(xf).requires_grad_(True)
    for _ in range(2):
        xf_t.grad = None
        with _settings(gt.settings, "cg", detach=False):
            fantasy = tm.get_fantasy_model(xf_t, torch.from_numpy(yf))
            fantasy(tx).mean.sum().backward()
        assert torch.isfinite(xf_t.grad).all() and xf_t.grad.abs().max() > 0
    with _settings(gt.settings, "cg"), torch.no_grad():
        mean = fantasy(tx).mean
    assert torch.isfinite(mean).all()


def test_fantasy_gradient_launches_the_symmetric_backward(monkeypatch):
    # on the CG branch with the hyperparameters live, the gradient of a fantasy model's Σμ*
    # runs the symmetric backward over the training rows once for the mean cache's solve
    # (t = 1) and once for the q solves A⁻¹B (t = q)
    calls = []
    plain = fk._bwd_fused_reference
    monkeypatch.setattr(fk, "_bwd_fused_reference", lambda x, g, v, *a, **k: calls.append((x.shape[0], v.shape[1]))
                        or plain(x, g, v, *a, **k))
    _, _, xf, yf, test_x = _task()
    tm = _torch_model()
    xf_t = torch.from_numpy(xf).requires_grad_(True)
    with _settings(gt.settings, "cg", detach=False):
        tm.refresh()
        fantasy = tm.get_fantasy_model(xf_t, torch.from_numpy(yf))
        fantasy(torch.from_numpy(test_x)).mean.sum().backward()
    assert sorted(calls) == [(N, 1), (N, Q)]


# -- the rest of ExactGP ---------------------------------------------------------------

def test_set_train_data_checks_shapes_and_clears_caches():
    train_x, train_y, xf, _, test_x = _task()
    tm = _torch_model()
    with torch.no_grad():
        tm(torch.from_numpy(test_x))
    assert "prediction_strategy" in tm._cache
    with pytest.raises(RuntimeError, match="train inputs"):
        tm.set_train_data(torch.from_numpy(np.concatenate([train_x, xf])))
    with pytest.raises(RuntimeError, match="train inputs"):
        tm.set_train_data(torch.from_numpy(train_x).float())
    with pytest.raises(RuntimeError, match="train targets"):
        tm.set_train_data(targets=torch.from_numpy(train_y[:-1]))
    tm.set_train_data(torch.from_numpy(train_x + 0.01), torch.from_numpy(train_y))
    assert "prediction_strategy" not in tm._cache
    tm.set_train_data(torch.from_numpy(train_x[:-3]), torch.from_numpy(train_y[:-3]), strict=False)
    assert tm.train_inputs[0].shape == (N - 3, D)
    with torch.no_grad():
        assert torch.isfinite(tm(torch.from_numpy(test_x)).mean).all()


@pytest.mark.parametrize("how", ["setting", "no training data"])
def test_prior_mode_matches_jax_package(how):
    train_x, train_y, _, _, test_x = _task()
    jm = JaxModel(jnp.asarray(train_x), jnp.asarray(train_y), gp.likelihoods.GaussianLikelihood())
    jm = jm.with_params({k: jnp.asarray(v) for k, v in PARAMS.items()}).eval()
    with gp.settings.prior_mode(True):
        want = jm(jnp.asarray(test_x))
    if how == "setting":
        tm = _torch_model()
        with gt.settings.prior_mode(True):
            got = tm(torch.from_numpy(test_x))
    else:
        tm = gt.load_jax_params(TorchModel(None, None, gt.likelihoods.GaussianLikelihood()).double(), PARAMS).eval()
        got = tm(torch.from_numpy(test_x))
    np.testing.assert_allclose(got.mean.detach().numpy(), np.asarray(want.mean), rtol=1e-12)
    np.testing.assert_allclose(got.covariance_matrix.detach().numpy(), np.asarray(want.covariance_matrix), rtol=1e-6)
    with pytest.raises(RuntimeError, match="train_targets without train_inputs"):
        TorchModel(None, torch.zeros(3), gt.likelihoods.GaussianLikelihood())


def test_debug_checks():
    train_x, _, _, _, test_x = _task()
    tm = _torch_model().train()
    with pytest.raises(RuntimeError, match="You must train on the training inputs"):
        tm(torch.from_numpy(test_x))
    with gt.settings.debug(False):
        tm(torch.from_numpy(test_x))
    tm.eval()
    with pytest.warns(GPInputWarning, match="matches the stored training data"), torch.no_grad():
        tm(torch.from_numpy(train_x.copy()))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with torch.no_grad():
            tm(torch.from_numpy(test_x))
            with gt.settings.debug(False):
                tm(torch.from_numpy(train_x))


def test_fantasy_noise_and_missing_data_raise():
    # new observations' noise needs a fixed-noise likelihood (tests/test_torch_fixed_noise.py)
    _, _, xf, yf, _ = _task()
    with pytest.raises(RuntimeError, match="get_fantasy_likelihood"):
        _torch_model().get_fantasy_model(torch.from_numpy(xf), torch.from_numpy(yf), noise=torch.ones(Q))
    with pytest.raises(RuntimeError, match="without training data"):
        TorchModel(None, None, gt.likelihoods.GaussianLikelihood()).get_fantasy_model(torch.from_numpy(xf),
                                                                                      torch.from_numpy(yf))
