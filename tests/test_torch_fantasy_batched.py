"""Fantasy models of batched, multitask and Dirichlet-classification GPs: the port against
the JAX package, in float64 on the CPU.

* A batch of b = 2 and 3 independent GPs (ConstantMean, ScaleKernel(RBFKernel(ard_num_dims=3))
  and GaussianLikelihood, each with ``batch_shape=(b,)``) conditioned on m new points per
  element: the block-Schur update per element ([..., :n, n:] slices of the joint prior), on
  the dense-Cholesky path (N=300) and by preconditioned CG at tolerance 1e-10 (N=700, over
  max_eager_kernel_size², so every solve streams through the fused product per element);
* the Kronecker multitask GP (MultitaskKernel(RBFKernel), MultitaskGaussianLikelihood),
  whose targets join on the data axis and whose caches are rebuilt on the joint operator;
* the three-class Dirichlet GP, whose fantasy likelihood is itself: the new points' D block
  takes the zero operator, i.e. no noise (the JAX package's behaviour, which the port shares).

Each fantasy's posterior is held against the JAX package's fantasy and against a model
built on the joint data.  The JAX side gets float64 distances and is ``jax.jit``ted.
Tolerance 1e-8 relative wherever both packages run the same float64 arithmetic in another
order.
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
import gpytorch_tpu_torch as gt
from gpytorch_tpu_torch.utils.warnings import GPInputWarning

D, PC_RANK = 3, 20
RTOL = 1e-8


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


def _task(n, b, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    fs = [np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]), np.cos(7 * x[:, 1]) * x[:, 2], np.sin(9 * x[:, 2] + x[:, 0])]
    y = np.stack(fs[:b]) + 0.1 * rng.normal(size=(b, n))
    return x, (y - y.mean(-1, keepdims=True)) / y.std(-1, keepdims=True)


def _params(b):
    ls = np.array([[[-0.4, 0.1, -0.7]], [[0.3, -0.5, 0.2]], [[-1.0, 0.6, 0.0]]])
    return {
        "covar_module.base_kernel.raw_lengthscale": ls[:b],
        "covar_module.raw_outputscale": np.array([0.5, -0.3, 1.1])[:b],
        "likelihood.noise_covar.raw_noise": np.array([[-2.0], [-1.5], [-2.5]])[:b],
        "mean_module.raw_constant": np.array([0.05, -0.1, 0.2])[:b],
    }


def _model_class(pkg, b):
    class BatchGP(pkg.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = pkg.means.ConstantMean(batch_shape=(b,))
            self.covar_module = pkg.kernels.ScaleKernel(pkg.kernels.RBFKernel(ard_num_dims=D, batch_shape=(b,)),
                                                        batch_shape=(b,))

        def forward(self, x):
            return pkg.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    return BatchGP


def _cg_settings(mod, cg):
    stack = contextlib.ExitStack()
    if cg:
        for ctx in (mod.max_cholesky_size(0), mod.min_preconditioning_size(0), mod.max_preconditioner_size(PC_RANK),
                    mod.preconditioner_noise_budget(1e-3), mod.cg_tolerance(1e-10), mod.eval_cg_tolerance(1e-10),
                    mod.max_cg_iterations(1000), mod.cg_stall_window(50)):
            stack.enter_context(ctx)
    return stack


def _split(n, m, q, b):
    """Training, fantasy and test parts of one draw: x (n, D), (m, D), (q, D); y (b, ·)."""
    x, y = _task(n + m + q, b)
    return x[:n], y[:, :n], x[n:n + m], y[:, n:n + m], x[n + m:]


@functools.lru_cache(maxsize=None)
def _jax_batch_fantasy(n, m, q, b, cg):
    x, y, xf, yf, xt = _split(n, m, q, b)

    @jax.jit
    def fantasy_posterior(p):
        jm = _model_class(gp, b)(jnp.broadcast_to(jnp.asarray(x), (b, n, D)), jnp.asarray(y),
                                 gp.likelihoods.GaussianLikelihood(batch_shape=(b,)))
        jm = jm.with_params(p).eval()
        with _cg_settings(gp.settings, cg):
            tz = jnp.broadcast_to(jnp.asarray(xt), (b, q, D))
            jm(tz)
            fant = jm.get_fantasy_model(jnp.broadcast_to(jnp.asarray(xf), (b, m, D)), jnp.asarray(yf))
            post = fant(tz)
            return post.mean, post.variance, fant._cache["prediction_strategy"].mean_cache

    return tuple(np.asarray(a) for a in fantasy_posterior({k: jnp.asarray(v) for k, v in _params(b).items()}))


def _torch_batch_model(x, y, b):
    model = _model_class(gt, b)(torch.from_numpy(x).expand((b,) + x.shape), torch.from_numpy(y),
                                gt.likelihoods.GaussianLikelihood(batch_shape=(b,)))
    return gt.load_jax_params(model.double(), _params(b)).eval()


@pytest.mark.parametrize("b,n,cg", [(2, 300, False), (3, 300, False), (2, 700, True)],
                         ids=["b2_cholesky", "b3_cholesky", "b2_cg"])
def test_batched_fantasy_matches_jax_package(b, n, cg):
    # m = 8 new points per element, (b, m, D) inputs and (b, m) targets: the mean cache of
    # the Schur update, the fantasy's posterior mean and variances at 30 test points against
    # the JAX package's fantasy (1e-8), and the mean cache against a model built on the
    # joint data
    m, q = 8, 30
    want_mean, want_var, want_cache = _jax_batch_fantasy(n, m, q, b, cg)
    x, y, xf, yf, xt = _split(n, m, q, b)
    model = _torch_batch_model(x, y, b)
    with _cg_settings(gt.settings, cg), torch.no_grad():
        model(torch.from_numpy(xt))
        fant = model.get_fantasy_model(torch.from_numpy(xf).expand(b, m, D), torch.from_numpy(yf))
        cache = fant.prediction_strategy().mean_cache
        post = fant(torch.from_numpy(xt))
        joint = _torch_batch_model(np.concatenate([x, xf]), np.concatenate([y, yf], -1), b)
        joint(torch.from_numpy(xt))
        joint_cache = joint.prediction_strategy().mean_cache
    assert fant.train_inputs[0].shape == (b, n + m, D) and fant.train_targets.shape == (b, n + m)
    assert cache.shape == (b, n + m)
    np.testing.assert_allclose(cache.numpy(), want_cache, rtol=RTOL, atol=RTOL * np.abs(want_cache).max())
    np.testing.assert_allclose(post.mean.numpy(), want_mean, rtol=RTOL, atol=RTOL * np.abs(want_mean).max())
    np.testing.assert_allclose(post.variance.numpy(), want_var, rtol=RTOL, atol=RTOL * want_var.max())
    # the refit solves the (n + m) system by CG at 1e-10 on its own: 1e-6 of the largest entry
    # there (the two read 3e-8 apart), 1e-8 against a dense factor
    refit_tol = 1e-6 if cg else RTOL
    np.testing.assert_allclose(cache.numpy(), joint_cache.numpy(), rtol=0, atol=refit_tol * np.abs(want_cache).max())


def _multitask_task(n, t, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, n)
    f = np.stack([np.sin(6 * x), np.cos(5 * x), x**2 - 0.3][:t], -1)
    return x, f + 0.1 * rng.normal(size=(n, t))


def _kron_model(pkg, t):
    class MultitaskGP(pkg.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = pkg.means.MultitaskMean(pkg.means.ConstantMean(), num_tasks=t)
            self.covar_module = pkg.kernels.MultitaskKernel(pkg.kernels.RBFKernel(), num_tasks=t, rank=1)

        def forward(self, x):
            return pkg.distributions.MultitaskMultivariateNormal(self.mean_module(x), self.covar_module(x))

    return MultitaskGP


@functools.lru_cache(maxsize=None)
def _jax_multitask_fantasy(n, m, t):
    x, y = _multitask_task(n + m, t)
    jm = _kron_model(gp, t)(jnp.asarray(x[:n]), jnp.asarray(y[:n]),
                            gp.likelihoods.MultitaskGaussianLikelihood(num_tasks=t))
    rng = np.random.default_rng(3)
    params = {k: np.asarray(v) + 0.2 * rng.normal(size=np.shape(v)) for k, v in jm.trainable_params().items()}

    @jax.jit
    def fantasy_posterior(p, xs):
        model = jm.with_params(p).eval()
        model(xs)
        fant = model.get_fantasy_model(jnp.asarray(x[n:]), jnp.asarray(y[n:]))
        post = fant(xs)
        return post.mean, post.variance

    mean, var = fantasy_posterior({k: jnp.asarray(v) for k, v in params.items()}, jnp.linspace(0.05, 0.95, 20))
    return params, np.asarray(mean), np.asarray(var)


def test_multitask_fantasy_matches_jax_package():
    # the Kronecker GP at n = 40 with 2 tasks conditioned on 6 new points (targets (6, 2),
    # joined on the data axis): no Schur update, the new strategy's caches built at first
    # use on the (n + m)·t joint operator (dense Cholesky); its posterior mean and variances
    # at 20 points against the JAX package's fantasy and a model built on the joint data, 1e-8
    n, m, t = 40, 6, 2
    params, want_mean, want_var = _jax_multitask_fantasy(n, m, t)
    x, y = _multitask_task(n + m, t)

    def model_on(k):
        model = _kron_model(gt, t)(torch.from_numpy(x[:k]), torch.from_numpy(y[:k]),
                                   gt.likelihoods.MultitaskGaussianLikelihood(num_tasks=t))
        return gt.load_jax_params(model.double(), params).eval()

    xs = torch.linspace(0.05, 0.95, 20, dtype=torch.float64)
    model = model_on(n)
    with torch.no_grad():
        model(xs)
        fant = model.get_fantasy_model(torch.from_numpy(x[n:]), torch.from_numpy(y[n:]))
        assert fant.train_targets.shape == (n + m, t)
        assert fant.prediction_strategy()._mean_cache is None
        post = fant(xs)
        ref = model_on(n + m)(xs)
    assert isinstance(post, gt.distributions.MultitaskMultivariateNormal) and post.mean.shape == (20, t)
    for got, want, joint in ((post.mean, want_mean, ref.mean), (post.variance, want_var, ref.variance)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), joint.numpy(), rtol=0, atol=RTOL * np.abs(want).max())


def _classification_task(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    f = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * x[:, 2] + 0.2 * rng.normal(size=n)
    return x, np.digitize(f, np.quantile(f, [1 / 3, 2 / 3])).astype(np.int64)


DIRICHLET_PARAMS = {
    "covar_module.base_kernel.raw_lengthscale": np.array([[[-0.4, 0.1, -0.7]], [[0.3, -0.5, 0.2]],
                                                          [[-1.0, 0.6, 0.0]]]),
    "covar_module.raw_outputscale": np.array([0.5, -0.3, 1.1]),
    "mean_module.raw_constant": np.array([0.05, -0.1, 0.2]),
}


def test_dirichlet_fantasy_takes_a_noise_free_block():
    # the Dirichlet likelihood's fantasy likelihood is itself, whose fixed noise holds the n
    # training points only: the m new points' D block is K(X_new, X_new) with no noise (the
    # zero operator, with the port's warning), as in the JAX package.  The fantasy's mean
    # cache against the JAX package's (1e-8) and against the dense joint solve with D = K_new
    # (1e-8); the joint solve with noise on the new points differs from it by far more
    n, m, c = 300, 6, 3
    x, labels = _classification_task(n + m)
    lik = gt.likelihoods.DirichletClassificationLikelihood(torch.from_numpy(labels[:n]), dtype=torch.float64)
    new_targets = gt.likelihoods.DirichletClassificationLikelihood(torch.from_numpy(labels),
                                                                   dtype=torch.float64).transformed_targets[:, n:]
    model = _model_class(gt, c)(torch.from_numpy(x[:n]).expand(c, n, D), lik.transformed_targets, lik)
    model = gt.load_jax_params(model.double(), DIRICHLET_PARAMS).eval()
    xf = torch.from_numpy(x[n:]).expand(c, m, D)
    with torch.no_grad():
        model(xf)
        with pytest.warns(GPInputWarning, match="no-noise"):
            fant = model.get_fantasy_model(xf, new_targets)
        cache = fant._cache["prediction_strategy"].mean_cache.numpy()

    jl = gp.likelihoods.DirichletClassificationLikelihood(jnp.asarray(labels[:n]), dtype=jnp.float64)
    jm = _model_class(gp, c)(jnp.broadcast_to(jnp.asarray(x[:n]), (c, n, D)), jl.transformed_targets, jl)
    jm = jm.with_params({k: jnp.asarray(v) for k, v in DIRICHLET_PARAMS.items()}).eval()

    @jax.jit
    def jax_cache(jxf, jyf):
        jm(jxf)
        return jm.get_fantasy_model(jxf, jyf)._cache["prediction_strategy"].mean_cache

    want = np.asarray(jax_cache(jnp.asarray(xf.numpy()), jnp.asarray(new_targets.numpy())))
    np.testing.assert_allclose(cache, want, rtol=RTOL, atol=RTOL * np.abs(want).max())

    with torch.no_grad():
        joint_x = torch.from_numpy(x).expand(c, n + m, D)
        k = model.covar_module(joint_x).to_dense().numpy()
        mu = model.mean_module(joint_x).numpy()
    noise = lik.noise.numpy()
    r = np.concatenate([lik.transformed_targets.numpy(), new_targets.numpy()], -1) - mu
    for free in (True, False):
        # psd_safe_cholesky's float64 jitter 1e-8 on the old system's factor and on S's is
        # the joint system's diagonal plus 1e-8
        a = k + 1e-8 * np.eye(n + m)
        a[:, :n, :n] += np.stack([np.diag(v) for v in noise])
        if not free:
            a[:, n:, n:] += np.eye(m) * noise.mean()
        dense = np.linalg.solve(a, r[..., None])[..., 0]
        gap = np.abs(cache - dense).max() / np.abs(dense).max()
        assert (gap < RTOL) if free else (gap > 1e-3), (free, gap)
