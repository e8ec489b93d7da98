"""Gradients of exact-GP predictions with respect to the test inputs: the port against the
JAX package, end to end, and the exact (non-LOVE) branch against central differences.

The flagship model of bench.py (ConstantMean + ScaleKernel(RBF or Matérn, ARD d=3) +
GaussianLikelihood) at N=700 train points, so that K(test, train) streams through the
fused products and its backward through ``_grad_x``.  The same numpy data, raw parameters
and Lanczos start block go through both packages in float64, with the JAX package's
float32 distance product swapped for a float64 one, as in tests/test_torch_exact_serving.py.
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
import gpytorch_tpu.solvers.lanczos
import gpytorch_tpu_torch as gt
from gpytorch_tpu.models import ExactGP as JaxExactGP
from gpytorch_tpu_torch.ops import fused_kernels as fk

N, M, D = 700, 400, 3
PARAMS = {
    "covar_module.base_kernel.raw_lengthscale": np.array([[-1.0, -0.5, -1.2]]),
    "covar_module.raw_outputscale": np.array(0.3),
    "likelihood.noise_covar.raw_noise": np.array([-3.5]),
    "mean_module.raw_constant": np.array(0.05),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _task(n, m, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n + m, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * np.sin(7 * x[:, 2] * x[:, 0]) + 0.1 * rng.normal(size=n + m)
    y = (y - y.mean()) / y.std()
    return x[:n], y[:n], x[n:], rng.normal(size=(n, 20))


def _jax_kernel(nu):
    return gp.kernels.RBFKernel(ard_num_dims=D) if nu is None else gp.kernels.MaternKernel(nu=nu, ard_num_dims=D)


def _torch_kernel(nu):
    return gt.kernels.RBFKernel(ard_num_dims=D) if nu is None else gt.kernels.MaternKernel(nu=nu, ard_num_dims=D)


class JaxModel(JaxExactGP):
    def __init__(self, x, y, likelihood, nu):
        super().__init__(x, y, likelihood)
        self.mean_module = gp.means.ConstantMean()
        self.covar_module = gp.kernels.ScaleKernel(_jax_kernel(nu))

    def forward(self, x):
        return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


class TorchModel(gt.models.ExactGP):
    def __init__(self, x, y, likelihood, nu=None, **kwargs):
        super().__init__(x, y, likelihood, **kwargs)
        self.mean_module = gt.means.ConstantMean()
        self.covar_module = gt.kernels.ScaleKernel(_torch_kernel(nu))

    def forward(self, x):
        return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


def _settings(mod, fast_pred_var=True, tol=1e-3, eager=512):
    stack = contextlib.ExitStack()
    for ctx in (
        mod.max_eager_kernel_size(eager),
        mod.max_cholesky_size(0),
        mod.min_preconditioning_size(0),
        mod.max_preconditioner_size(50),
        mod.preconditioner_noise_budget(1e-3),
        mod.eval_cg_tolerance(tol),
        mod.cg_stall_window(50),
        mod.max_root_decomposition_size(100),
        mod.fast_pred_var(fast_pred_var),
    ):
        stack.enter_context(ctx)
    return stack


def _exact_float64_sq_dist(x1, x2, x1_eq_x2=False):
    adj = jnp.mean(x1, axis=-2, keepdims=True)
    x1, x2 = x1 - adj, x2 - adj
    res = (
        -2.0 * jnp.matmul(x1, jnp.swapaxes(x2, -1, -2), precision=jax.lax.Precision.HIGHEST)
        + jnp.sum(x1 * x1, -1, keepdims=True)
        + jnp.swapaxes(jnp.sum(x2 * x2, -1, keepdims=True), -1, -2)
    )
    if x1_eq_x2:
        res = res * (1.0 - jnp.eye(res.shape[-1], dtype=res.dtype))
    return jnp.maximum(res, 0.0)


def _objectives(latent, predictive):
    """Σμ and Σσ² of the latent posterior, and Σ UCB = Σ μ + 2σ of the predictive."""
    return latent.mean.sum(), latent.variance.sum(), (predictive.mean + 2.0 * predictive.variance ** 0.5).sum()


@functools.lru_cache(maxsize=None)
def _gradients(nu, m, eager=512):
    """(values, gradients) of the three objectives with respect to the test inputs, from
    both packages, as numpy: values (3,) and gradients (3, m, D); kernel blocks of at most
    ``eager``² entries are evaluated densely."""
    train_x, train_y, test_x, block = _task(N, m)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpytorch_tpu.solvers.lanczos, "_block_init", lambda linop, iv, b: jnp.asarray(block))
        mp.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
        mp.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)

        def objectives(q, params):
            # the model is built inside the traced function: one built outside would leak
            # tracers from its cached prediction strategy
            jm = JaxModel(jnp.asarray(train_x), jnp.asarray(train_y), gp.likelihoods.GaussianLikelihood(), nu)
            jm = jm.with_params(params).eval()
            with _settings(gp.settings, eager=eager):
                latent = jm(q)
                return jnp.stack(_objectives(latent, jm.likelihood(latent)))

        params = {k: jnp.asarray(v) for k, v in PARAMS.items()}
        q = jnp.asarray(test_x)
        values, grads = jax.jit(lambda q_, p: (objectives(q_, p), jax.jacrev(objectives)(q_, p)))(q, params)
        out["jax"] = np.asarray(values), np.asarray(grads)

    tm = TorchModel(torch.from_numpy(train_x), torch.from_numpy(train_y), gt.likelihoods.GaussianLikelihood(), nu,
                    lanczos_init=torch.from_numpy(block)).double()
    gt.load_jax_params(tm, PARAMS)
    tm.eval()
    q = torch.from_numpy(test_x).requires_grad_(True)
    with _settings(gt.settings, eager=eager):
        latent = tm(q)
        values = _objectives(latent, tm.likelihood(latent))
        grads = [torch.autograd.grad(v, q, retain_graph=True)[0] for v in values]
    out["torch"] = torch.stack(values).detach().numpy(), torch.stack(grads).numpy()
    return out


@pytest.mark.parametrize("which", ["mean", "variance", "ucb"])
def test_prediction_gradient_matches_jax_package(which):
    i = ["mean", "variance", "ucb"].index(which)
    got, want = _gradients(None, M)["torch"], _gradients(None, M)["jax"]
    np.testing.assert_allclose(got[0][i], want[0][i], rtol=1e-9)
    assert np.isfinite(got[1][i]).all()
    np.testing.assert_allclose(got[1][i], want[1][i], rtol=0, atol=1e-8 * np.abs(want[1][i]).max())


# Both packages form K(train, train) from the distance expansion, whose diagonal holds
# round-off (d2 ~ 1e-17, r ~ 3e-9) that each sums in its own order.  Matérn-½'s
# k = exp(−r) passes r on at first order, so its mean cache differs by ~1e-8 between the
# packages (measured 1.1e-8 in the mean and 2.6e-8 in its gradient); ν = 3/2 and 5/2 see
# r², and their differences are 1e-9 and below.
MATERN_TOL = {0.5: 1e-7, 1.5: 1e-8, 2.5: 1e-8}


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_matern_prediction_and_gradient_match_jax_package(nu):
    # serving values (Σμ, Σσ², Σ UCB) and their input gradients at 40 test points, with
    # every kernel block lazy: K(test, train) streams, and the variances take K(test, test)'s
    # exact diagonal
    (got_v, got_g), (want_v, want_g) = _gradients(nu, 40, 16)["torch"], _gradients(nu, 40, 16)["jax"]
    np.testing.assert_allclose(got_v, want_v, rtol=MATERN_TOL[nu])
    assert np.isfinite(got_g).all()
    for got, want in zip(got_g, want_g):
        np.testing.assert_allclose(got, want, rtol=0, atol=MATERN_TOL[nu] * np.abs(want).max())


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_load_jax_params_carries_matern_lengthscale(nu):
    train_x, train_y, _, _ = _task(50, 0)
    jm = JaxModel(jnp.asarray(train_x), jnp.asarray(train_y), gp.likelihoods.GaussianLikelihood(), nu)
    jm = jm.with_params({k: jnp.asarray(v) for k, v in PARAMS.items()})
    assert set(jm.trainable_params()) == set(PARAMS)
    tm = gt.load_jax_params(TorchModel(torch.from_numpy(train_x), torch.from_numpy(train_y),
                                       gt.likelihoods.GaussianLikelihood(), nu).double(), PARAMS)
    assert tm.covar_module.base_kernel.nu == nu
    assert fk.kernel_type_for(tm.covar_module.base_kernel) == gp.ops.pallas_kernels.kernel_type_for(jm.covar_module.base_kernel)
    np.testing.assert_allclose(tm.covar_module.base_kernel.lengthscale.detach().numpy(),
                               np.asarray(jm.covar_module.base_kernel.lengthscale), rtol=1e-12)


def test_exact_branch_gradient_matches_central_differences():
    # The exact (non-LOVE) branch, K** − K*x (K + σ²I)⁻¹ Kx*, differentiated through the
    # solve's right-hand side, against central differences of the same variance computed
    # densely by Cholesky.  Not compared with the JAX package: it detaches the solve result
    # (gpytorch_tpu/models/exact_prediction_strategies.py:147), which drops one of the two
    # symmetric terms of the variance's derivative and halves its gradient.
    train_x, train_y, test_x, _ = _task(N, 30)
    tm = TorchModel(torch.from_numpy(train_x), torch.from_numpy(train_y), gt.likelihoods.GaussianLikelihood()).double()
    gt.load_jax_params(tm, PARAMS)
    tm.eval()
    q = torch.from_numpy(test_x).requires_grad_(True)
    with _settings(gt.settings, fast_pred_var=False, tol=1e-11), gt.settings.max_eager_kernel_size(64):
        var = tm(q).variance
    (grad,) = torch.autograd.grad(var.sum(), q)

    kern, noise = tm.covar_module, tm.likelihood.noise.detach()
    ls, os_ = kern.base_kernel.lengthscale.detach(), kern.outputscale.detach()
    tx = torch.from_numpy(train_x)

    def k(a, b):
        return os_ * torch.exp(-0.5 * (((a[:, None] - b[None]) / ls) ** 2).sum(-1))

    chol = torch.linalg.cholesky(k(tx, tx) + noise * torch.eye(N, dtype=torch.float64))

    def dense_var_sum(x):
        kxs = k(tx, x)
        return (os_ - (kxs * torch.cholesky_solve(kxs, chol)).sum(0)).sum()

    h, fd = 1e-5, torch.zeros(4, D, dtype=torch.float64)
    for i in range(4):
        for j in range(D):
            e = torch.zeros_like(q)
            e[i, j] = h
            fd[i, j] = (dense_var_sum(q.detach() + e) - dense_var_sum(q.detach() - e)) / (2 * h)
    torch.testing.assert_close(var.detach().sum(), dense_var_sum(q.detach()), rtol=1e-9, atol=0)
    torch.testing.assert_close(grad[:4], fd, rtol=0, atol=1e-7 * fd.abs().max().item())


@pytest.mark.parametrize("live", [False, True])
def test_gradient_runs_one_backward_pass_per_product(live, monkeypatch):
    # With the parameters frozen, the gradient of Σ UCB runs one _grad_x over the test rows
    # for each product of the prediction (the mean cache and the LOVE root) and no pass on
    # the training side: K(test, train) carries no history on its training inputs.  With
    # them live, each product adds its dx2 pass over the training rows and its dos product.
    train_x, train_y, test_x, block = _task(N, 40)
    tm = TorchModel(torch.from_numpy(train_x), torch.from_numpy(train_y), gt.likelihoods.GaussianLikelihood(),
                    lanczos_init=torch.from_numpy(block)).double()
    gt.load_jax_params(tm, PARAMS)
    tm.eval()
    for p in tm.parameters():
        p.requires_grad_(live)
    q = torch.from_numpy(test_x).requires_grad_(True)
    calls = []
    grad_x, product = fk._grad_x, fk._product
    with _settings(gt.settings), gt.settings.max_eager_kernel_size(64):
        with torch.no_grad():
            tm.refresh()
        monkeypatch.setattr(fk, "_product", lambda *a: calls.append(("product", a[0].shape[0], a[2].shape[1])) or product(*a))
        latent = tm(q)
        ucb = (latent.mean + 2.0 * latent.variance.sqrt()).sum()
        assert calls == [("product", 40, 1), ("product", 40, 100)]
        calls.clear()
        monkeypatch.setattr(fk, "_grad_x", lambda *a: calls.append(("grad_x", a[0].shape[0], a[2].shape[1])) or grad_x(*a))
        ucb.backward()
    want = {("grad_x", 40, 1), ("grad_x", 40, 100)}
    if live:
        want |= {("grad_x", N, 1), ("grad_x", N, 100), ("product", 40, 1), ("product", 40, 100)}
    assert sorted(calls) == sorted(want)
    assert torch.isfinite(q.grad).all()


def test_test_train_block_takes_the_training_inputs_themselves():
    train = torch.randn(6, 2, dtype=torch.float64)
    test = torch.randn(3, 2, dtype=torch.float64, requires_grad=True)
    op = gt.kernels.RBFKernel()(gt.linop.join_rows(train, test))
    cross, test_test = op[6:, :6], op[6:, 6:]
    assert cross.x1 is test and cross.x2 is train and not cross.x2.requires_grad
    assert test_test.symmetric and test_test.x1 is test
    assert op[2:4, :6].x1.shape == (2, 2)  # any other slice slices the joined tensor

