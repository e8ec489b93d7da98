"""LOVE differentiated through its Lanczos roots (``fast_pred_var`` and ``fast_pred_samples``
under ``detach_test_caches(False)``), the port against ``jax.grad`` of the JAX package in
float64 on the CPU.

The flagship model of bench.py (ConstantMean + ScaleKernel(RBF-ARD, d=3) +
GaussianLikelihood) at N=150 train points, Q=5 fantasy points and M=30 test points, with
the same numpy data, raw parameters and Lanczos start blocks (keyed by their shape,
injected into both packages by replacing each one's ``_block_init``) and the JAX
package's float32 distance product swapped for a float64 one.  Two branches: the LOVE
inverse root from a dense Cholesky factor at the default settings, and from block Lanczos
(with CG solves and every kernel block lazy, the fused products' plain versions) under
max_cholesky_size(0).  The sample root is a Lanczos root on both.

Tolerance: 1e-7 of the largest entry of each gradient (the same arithmetic in another
order; the eigh backward divides by gaps between Ritz values, which amplifies round-off,
and the CG branch's solves stop on a tolerance of 1e-11 after the same iterations in both
packages).  The port's ``get_fantasy_model`` deep-copies the model, so a hyperparameter's
gradient is the sum of the old model's and the copy's.
"""

import contextlib
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu.linop.added_diag
import gpytorch_tpu.solvers.lanczos
import gpytorch_tpu_torch as gt
import gpytorch_tpu_torch.solvers.lanczos
from gpytorch_tpu.models import ExactGP as JaxExactGP

N, Q, M, D = 150, 5, 30, 3
PARAMS = {
    "covar_module.base_kernel.raw_lengthscale": np.array([[-1.0, -0.5, -1.2]]),
    "covar_module.raw_outputscale": np.array(0.3),
    "likelihood.noise_covar.raw_noise": np.array([-3.5]),
    "mean_module.raw_constant": np.array(0.05),
}
RTOL = 1e-7


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


def _base_draw(shape):
    return np.random.default_rng([13, *shape]).normal(size=shape)


def _settings(mod, branch, samples=False, detach=False):
    """The branch's solver settings, under fast_pred_var (``samples`` False) or
    fast_pred_samples (True), or neither (None)."""
    stack = contextlib.ExitStack()
    ctxs = [mod.detach_test_caches(detach), mod.cg_tolerance(1e-11), mod.eval_cg_tolerance(1e-11),
            mod.cg_stall_window(50)]
    if samples is not None:
        ctxs.append((mod.fast_pred_samples if samples else mod.fast_pred_var)(True))
    if branch == "lanczos":
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


def _torch_model():
    train_x, train_y, _, _, _ = _task()
    tm = TorchModel(torch.from_numpy(train_x), torch.from_numpy(train_y), gt.likelihoods.GaussianLikelihood()).double()
    return gt.load_jax_params(tm, PARAMS).eval()


def _jax_objective(post, samples):
    """Σσ² under fast_pred_var; under fast_pred_samples the sum of draws from fixed base
    samples, weighted so that every entry of the sample root counts."""
    if not samples:
        return post.variance.sum()
    root = post.lazy_covariance_matrix.root
    u = jnp.asarray(_base_draw((4, root.shape[-1])))
    w = jnp.asarray(_base_draw((4, M)))
    return (w * post.rsample_from_base_samples(u)).sum()


def _torch_objective(post, samples):
    if not samples:
        return post.variance.sum()
    root = post.lazy_covariance_matrix.root
    u = torch.from_numpy(_base_draw((4, root.shape[-1])))
    w = torch.from_numpy(_base_draw((4, M)))
    return (w * post.rsample_from_base_samples(u)).sum()


@functools.lru_cache(maxsize=None)
def _jax_gradients(branch, target):
    """value_and_grad of both objectives (Σσ² under fast_pred_var, the weighted draws under
    fast_pred_samples), in one jitted program: {samples: (value, ∇X_f, ∇θ)}."""
    train_x, train_y, xf, yf, test_x = _task()

    def f(xf_, params, samples):
        jm = JaxModel(jnp.asarray(train_x), jnp.asarray(train_y), gp.likelihoods.GaussianLikelihood())
        jm = jm.with_params(params).eval()
        # the settings stay in force while the VJP is traced (the JAX solve VJP reads them then)
        with _settings(gp.settings, branch, samples):
            if target == "fantasy":
                jm(jnp.asarray(test_x))
                jm = jm.get_fantasy_model(xf_, jnp.asarray(yf))
            return _jax_objective(jm(jnp.asarray(test_x)), samples)

    def both(xf_, params):
        return [jax.value_and_grad(functools.partial(f, samples=samples), argnums=(0, 1))(xf_, params)
                for samples in (False, True)]

    params = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    with _settings(gp.settings, branch, None):
        out = jax.jit(both)(jnp.asarray(xf), params)
    return {samples: (float(value), np.asarray(g_xf), {k: np.asarray(v) for k, v in g_params.items()})
            for samples, (value, (g_xf, g_params)) in zip((False, True), out)}


def _torch_gradients(tm, branch, target, samples):
    _, _, xf, yf, test_x = _task()
    tx = torch.from_numpy(test_x)
    xf_t = torch.from_numpy(xf).requires_grad_(True)
    model = tm
    with _settings(gt.settings, branch, samples):
        if target == "fantasy":
            tm(tx)
            model = tm.get_fantasy_model(xf_t, torch.from_numpy(yf))
        value = _torch_objective(model(tx), samples)
    value.backward()
    own, copied = dict(tm.named_parameters()), dict(model.named_parameters())
    params = [own] if model is tm else [own, copied]
    grads = {name: sum((p[name].grad for p in params if p[name].grad is not None),
                       torch.zeros_like(own[name])).detach().numpy() for name in PARAMS}
    return value.item(), (xf_t.grad.numpy() if xf_t.grad is not None else None), grads


def _assert_gradients_match(got, want):
    value, g_xf, g_p = got
    want_v, want_xf, want_p = want
    np.testing.assert_allclose(value, want_v, rtol=RTOL)
    if g_xf is not None:
        assert np.abs(want_xf).max() > 0
        np.testing.assert_allclose(g_xf, want_xf, rtol=0, atol=RTOL * np.abs(want_xf).max())
    for name in PARAMS:
        np.testing.assert_allclose(g_p[name], want_p[name], rtol=RTOL, atol=RTOL * np.abs(want_p[name]).max(),
                                   err_msg=name)


@pytest.mark.parametrize("target", ["model", "fantasy"])
@pytest.mark.parametrize("branch", ["cholesky", "lanczos"])
def test_love_variance_gradient_matches_jax_package(branch, target, injected):
    # ∇θ (and for a fantasy model ∇X_f) of Σσ² under fast_pred_var: through the inverse
    # root R of the training operator (a fantasy model's on the joint n + q operator with
    # X_f's history) and through K*x R
    want = _jax_gradients(branch, target)[False]
    got = _torch_gradients(_torch_model(), branch, target, False)
    _assert_gradients_match(got, want)
    assert (got[1] is not None) == (target == "fantasy")


@pytest.mark.parametrize("target", ["model", "fantasy"])
@pytest.mark.parametrize("branch", ["cholesky", "lanczos"])
def test_love_sample_gradient_matches_jax_package(branch, target, injected):
    # a draw under fast_pred_samples, μ* + R_s u from fixed base samples, through the sample
    # root's Lanczos run on K** − (K*x R)(K*x R)ᵀ and the inverse root R beneath it
    want = _jax_gradients(branch, target)[True]
    got = _torch_gradients(_torch_model(), branch, target, True)
    _assert_gradients_match(got, want)


def test_ritz_floor_carries_no_gradient(injected, monkeypatch):
    # In float32 at N=100k the smallest Ritz values of K + σ²I fall below σ² and are clamped
    # to it.  Raising the floor to 40σ² in both packages clamps some of them here, in
    # float64; a clamped value is a constant of the gradient in both (the JAX package's
    # stop_gradient), so it sends nothing to the noise through the floor.
    factor = 40.0
    jax_bound = gpytorch_tpu.linop.added_diag.AddedDiagLinearOperator._eig_lower_bound
    torch_bound = gt.linop.AddedDiagLinearOperator._eig_lower_bound
    monkeypatch.setattr(gpytorch_tpu.linop.added_diag.AddedDiagLinearOperator, "_eig_lower_bound",
                        lambda self: None if jax_bound(self) is None else factor * jax_bound(self))
    bounds, ritz = [], []

    def raised(self):
        bound = torch_bound(self)
        if bound is not None:
            bounds.append(float(factor * bound.detach()))
            return factor * bound
        return None

    def recorded(matmul_fn, init_block, num_blocks):
        Qf, T = lanczos_ritz(matmul_fn, init_block, num_blocks)
        ritz.append(torch.linalg.eigvalsh(T.detach()))
        return Qf, T

    lanczos_ritz = gpytorch_tpu_torch.solvers.lanczos.block_lanczos_ritz
    monkeypatch.setattr(gt.linop.AddedDiagLinearOperator, "_eig_lower_bound", raised)
    monkeypatch.setattr(gpytorch_tpu_torch.solvers.lanczos, "block_lanczos_ritz", recorded)
    train_x, train_y, _, _, test_x = _task()

    def f(params):
        jm = JaxModel(jnp.asarray(train_x), jnp.asarray(train_y), gp.likelihoods.GaussianLikelihood())
        return jm.with_params(params).eval()(jnp.asarray(test_x)).variance.sum()

    with _settings(gp.settings, "lanczos"):
        want = jax.jit(jax.grad(f))({k: jnp.asarray(v) for k, v in PARAMS.items()})
    tm = _torch_model()
    with _settings(gt.settings, "lanczos"):
        tm(torch.from_numpy(test_x)).variance.sum().backward()
    assert len(ritz) == 1 and bounds
    assert (ritz[0] < bounds[-1]).sum() > 0, "the floor clamps no Ritz value"
    for name, p in tm.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want[name]), rtol=RTOL,
                                   atol=RTOL * np.abs(np.asarray(want[name])).max(), err_msg=name)


def _grads(model):
    return [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("samples", [False, True], ids=["fast_pred_var", "fast_pred_samples"])
def test_love_strategy_with_history_serves_one_call(samples):
    # a strategy with autograd history, LOVE caches included, serves one call: two
    # backward passes in a row both run and read the same gradient; a call under the
    # default then takes the strategy without history, whose LOVE cache is the same value
    # detached, and whose gradient (the test side alone) differs
    _, _, _, _, test_x = _task()
    tm = _torch_model()
    tx = torch.from_numpy(test_x)
    grads = []
    for _ in range(2):
        tm.zero_grad()
        with _settings(gt.settings, "cholesky", samples):
            _torch_objective(tm(tx), samples).backward()
        grads.append(_grads(tm))
        strategy = tm._cache["prediction_strategy"]
        assert strategy.spent and strategy.with_graph and strategy._covar_cache.requires_grad
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=0)
    with_history = tm._cache["prediction_strategy"]._covar_cache
    tm.zero_grad()
    with _settings(gt.settings, "cholesky", samples, detach=True):
        _torch_objective(tm(tx), samples).backward()
    strategy = tm._cache["prediction_strategy"]
    assert not strategy.with_graph and not strategy._covar_cache.requires_grad
    torch.testing.assert_close(strategy._covar_cache, with_history.detach(), rtol=0, atol=0)
    assert any(not torch.allclose(a, b) for a, b in zip(_grads(tm), grads[0]))
