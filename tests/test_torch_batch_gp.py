"""The port's batch-independent exact GPs against the JAX package, in float64 on the CPU.

A batch of b independent GPs (ConstantMean, ScaleKernel(RBFKernel(ard_num_dims=3)) and
GaussianLikelihood, each with ``batch_shape=(b,)``) on inputs shared by the batch, broadcast
to (b, n, d) as ``tests/test_integration_parity_gaps.py`` does, with its own targets,
hyperparameters and noise per element.  The same numpy data and raw parameters go through
both packages: the MLL (one value per element) and its gradient in every raw parameter on
the dense-Cholesky path (N=300) and on mBCG (N=1200, over max_eager_kernel_size², so every
product streams through the fused product per element), the posterior mean and variances
(exact, and LOVE from block Lanczos), and the batched periodic branch.  Probes and Lanczos
start blocks are injected into both packages, keyed by their batched shapes; the JAX side
gets float64 distances (its ``sq_dist`` forms the distance product in float32 even under
x64) and is ``jax.jit``ted.

Tolerances are stated at each test: 1e-8 relative wherever both packages run the same
float64 arithmetic in another order.
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
import gpytorch_tpu.linop.root
import gpytorch_tpu.solvers.lanczos
import gpytorch_tpu_torch as gt
import gpytorch_tpu_torch.solvers.lanczos
from gpytorch_tpu_torch.ops import fused_kernels as fk

D, PROBES, PC_RANK = 3, 8, 20
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


def _draw(tag, shape):
    return np.random.default_rng([tag, *shape]).normal(size=shape)


# the probe draws of the JAX call being traced: an argument of the jitted function
_JAX_DRAWS = {}


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    """Float64 distances in JAX; probes and Lanczos start blocks injected, keyed by shape."""
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    monkeypatch.setattr(gpytorch_tpu.linop.root, "probe_base_samples",
                        lambda key, shape, dtype: _JAX_DRAWS["draws"][tuple(shape)].astype(dtype))
    monkeypatch.setattr(gpytorch_tpu.solvers.lanczos, "_block_init",
                        lambda linop, iv, b: jnp.asarray(_draw(9, linop.batch_shape + (linop.shape[-1], b))))
    monkeypatch.setattr(gpytorch_tpu_torch.solvers.lanczos, "_block_init",
                        lambda linop, iv, b: torch.from_numpy(_draw(9, linop.batch_shape + (linop.shape[-1], b))))


def _task(n, b, seed=0):
    """Shared inputs (n, D); b targets, each a function of its own with noise 0.1."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    fs = [np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]), np.cos(7 * x[:, 1]) * x[:, 2], np.sin(9 * x[:, 2] + x[:, 0])]
    y = np.stack(fs[:b]) + 0.1 * rng.normal(size=(b, n))
    return x, (y - y.mean(-1, keepdims=True)) / y.std(-1, keepdims=True)


def _params(b):
    """Raw parameters that differ between the elements."""
    ls = np.array([[[-0.4, 0.1, -0.7]], [[0.3, -0.5, 0.2]], [[-1.0, 0.6, 0.0]]])
    return {
        "covar_module.base_kernel.raw_lengthscale": ls[:b],
        "covar_module.raw_outputscale": np.array([0.5, -0.3, 1.1])[:b],
        "likelihood.noise_covar.raw_noise": np.array([[-2.0], [-1.5], [-2.5]])[:b],
        "mean_module.raw_constant": np.array([0.05, -0.1, 0.2])[:b],
    }


def _model_class(pkg, b, periodic=False):
    def kernel():
        if periodic:
            return pkg.kernels.PeriodicKernel(ard_num_dims=2, batch_shape=(b,))
        return pkg.kernels.RBFKernel(ard_num_dims=D, batch_shape=(b,))

    class BatchGP(pkg.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = pkg.means.ConstantMean(batch_shape=(b,))
            self.covar_module = pkg.kernels.ScaleKernel(kernel(), batch_shape=(b,))

        def forward(self, x):
            return pkg.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    return BatchGP


def _solver_settings(mod, mbcg):
    stack = contextlib.ExitStack()
    if mbcg:
        for ctx in (mod.max_cholesky_size(0), mod.min_preconditioning_size(0), mod.max_cg_iterations(200),
                    mod.cg_tolerance(1e-2), mod.num_trace_samples(PROBES), mod.max_lanczos_quadrature_iterations(5),
                    mod.max_preconditioner_size(PC_RANK), mod.cg_stall_window(10),
                    mod.preconditioner_noise_budget(1e-3), mod.fast_precond_grad(True)):
            stack.enter_context(ctx)
    return stack


def _probe_shapes(n, b):
    # the probes' base samples with the rank-PC_RANK preconditioner: (t, b, k, 1), (t, b, n)
    return ((PROBES, b, PC_RANK, 1), (PROBES, b, n))


def _torch_model(x, y, params, periodic=False):
    b = y.shape[0]
    tx = torch.from_numpy(x).expand((b,) + x.shape)
    model = _model_class(gt, b, periodic)(tx, torch.from_numpy(y), gt.likelihoods.GaussianLikelihood(batch_shape=(b,)))
    return gt.load_jax_params(model.double(), params)


@functools.lru_cache(maxsize=None)
def _jax_loss(n, b, mbcg, periodic=False):
    """jit(value_and_grad) of −Σ_b MLL_b over the raw parameters, and the per-element MLL."""
    x, y = _periodic_task(n, b) if periodic else _task(n, b)
    jx, jy = jnp.broadcast_to(jnp.asarray(x), (b,) + x.shape), jnp.asarray(y)
    jm = _model_class(gp, b, periodic)(jx, jy, gp.likelihoods.GaussianLikelihood(batch_shape=(b,)))

    def loss(p, draws):
        _JAX_DRAWS["draws"] = draws
        m = jm.with_params(p)
        with _solver_settings(gp.settings, mbcg):
            mll = gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(jx), jy, key=jax.random.PRNGKey(0))
        return -jnp.sum(mll), mll

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _torch_loss(model, mbcg):
    tx, ty = model.train_inputs[0], model.train_targets
    with _solver_settings(gt.settings, mbcg):
        mll = gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)(model(tx), ty,
                                                                           base_samples=lambda s: _draw(0, s))
    model.zero_grad()
    (-mll.sum()).backward()
    return mll.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


def _check_mll(n, b, mbcg, periodic=False):
    params = _params(b) if not periodic else _periodic_params(b)
    draws = {s: jnp.asarray(_draw(0, s)) for s in _probe_shapes(n, b)}
    (_, jmll), jgrad = _jax_loss(n, b, mbcg, periodic)({k: jnp.asarray(v) for k, v in params.items()}, draws)
    x, y = _periodic_task(n, b) if periodic else _task(n, b)
    tmll, tgrad = _torch_loss(_torch_model(x, y, params, periodic), mbcg)
    assert tmll.shape == (b,)
    np.testing.assert_allclose(tmll.numpy(), np.asarray(jmll), rtol=RTOL)
    assert set(tgrad) == set(jgrad)
    for name, g in tgrad.items():
        want = np.asarray(jgrad[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("b", [2, 3])
def test_batch_mll_and_gradient_on_the_cholesky_path_match_jax_package(b):
    # N=300 ≤ max_cholesky_size: one dense Cholesky factor per element; 1e-8 relative
    _check_mll(300, b, mbcg=False)


def test_batch_mll_and_gradient_by_mbcg_match_jax_package():
    # N=1200 under max_cholesky_size(0): one CG loop over both elements' [y, 8 probes] with a
    # rank-20 preconditioner per element, the fused products one element at a time;
    # 1e-8 relative (the two packages read 1e-15 apart)
    _check_mll(1200, 2, mbcg=True)


def _periodic_task(n, b):
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(0, 6, size=n))
    x = np.stack([t, t], axis=1)
    fs = [np.sin(2 * np.pi * t) + 0.5 * np.cos(2 * np.pi * t / 3), np.cos(2 * np.pi * t / 2) * np.sin(np.pi * t)]
    y = np.stack(fs[:b]) + 0.1 * rng.normal(size=(b, n))
    return x, (y - y.mean(-1, keepdims=True)) / y.std(-1, keepdims=True)


def _periodic_params(b):
    return {
        "covar_module.base_kernel.raw_lengthscale": np.array([[[0.2, -0.3]], [[-0.4, 0.5]]])[:b],
        "covar_module.base_kernel.raw_period_length": np.array([[[0.5, 2.9]], [[1.4, 0.2]]])[:b],
        "covar_module.raw_outputscale": np.array([0.4, -0.2])[:b],
        "likelihood.noise_covar.raw_noise": np.array([[-2.0], [-1.0]])[:b],
        "mean_module.raw_constant": np.array([0.05, -0.1])[:b],
    }


def test_batched_periodic_branch_matches_jax_package():
    # ScaleKernel(PeriodicKernel(ard_num_dims=2)) per element at N=700 by mBCG: the batched
    # periodic branch, one fused periodic product per element with its own period,
    # lengthscale and outputscale (the JAX package folds the outputscale into the
    # right-hand side, the port keeps it an operand: equal in exact arithmetic); 1e-8
    _check_mll(700, 2, mbcg=True, periodic=True)


@functools.lru_cache(maxsize=None)
def _jax_posterior(n, m, b, love):
    x, y = _task(n + m, b)
    train_x, train_y, test_x = x[:n], y[:, :n], x[n:]
    jx = jnp.broadcast_to(jnp.asarray(train_x), (b, n, D))

    @jax.jit
    def posterior(p, tx):
        jm = _model_class(gp, b)(jx, jnp.asarray(train_y), gp.likelihoods.GaussianLikelihood(batch_shape=(b,)))
        jm = jm.with_params(p).eval()
        with _serving_settings(gp.settings, love):
            post = jm(jnp.broadcast_to(tx, (b,) + tx.shape))
            return post.mean, post.variance

    mean, var = posterior({k: jnp.asarray(v) for k, v in _params(b).items()}, jnp.asarray(test_x))
    return np.asarray(mean), np.asarray(var)


def _serving_settings(mod, love):
    stack = contextlib.ExitStack()
    if love:
        for ctx in (mod.max_cholesky_size(0), mod.min_preconditioning_size(0), mod.max_preconditioner_size(PC_RANK),
                    mod.preconditioner_noise_budget(1e-3), mod.eval_cg_tolerance(1e-10), mod.max_cg_iterations(1000),
                    mod.cg_stall_window(50), mod.fast_pred_var(True), mod.max_root_decomposition_size(60)):
            stack.enter_context(ctx)
    return stack


@pytest.mark.parametrize("love", [False, True], ids=["cholesky_exact", "lanczos_love"])
def test_batch_posterior_mean_and_variances_match_jax_package(love):
    # N=300 (b=3) on the dense-Cholesky path with exact variances; N=700 (b=2) under
    # max_cholesky_size(0) with the mean cache by preconditioned CG at tolerance 1e-10 and
    # LOVE variances from a rank-60 block-Lanczos root per element from injected start
    # blocks.  1e-8 of the largest mean and variance
    n, m, b = (700, 60, 2) if love else (300, 60, 3)
    want_mean, want_var = _jax_posterior(n, m, b, love)
    x, y = _task(n + m, b)
    model = _torch_model(x[:n], y[:, :n], _params(b)).eval()
    with _serving_settings(gt.settings, love), torch.no_grad():
        post = model(torch.from_numpy(x[n:]))
        mean, var = post.mean.numpy(), post.variance.numpy()
    assert mean.shape == var.shape == (b, m)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=RTOL * np.abs(want_mean).max())
    np.testing.assert_allclose(var, want_var, rtol=0, atol=RTOL * np.abs(want_var).max())


def test_batched_model_agrees_with_one_unbatched_model_per_element():
    # the batched MLL, its gradient and the posterior mean of each element against an
    # unbatched port model with that element's parameters, on the same inputs: no state is
    # shared between the elements (1e-10 relative: the same arithmetic, batched)
    n, b = 300, 2
    x, y = _task(n, b)
    params = _params(b)
    batched = _torch_model(x, y, params)
    mll, grads = _torch_loss(batched, mbcg=False)
    for i in range(b):
        single = {k: v[i] for k, v in params.items()}
        model = _model_class(gt, 1)(torch.from_numpy(x), torch.from_numpy(y[i]), gt.likelihoods.GaussianLikelihood())
        model.mean_module = gt.means.ConstantMean()
        model.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D))
        model = gt.load_jax_params(model.double(), single)
        one, g1 = _torch_loss(model, mbcg=False)
        np.testing.assert_allclose(one.item(), mll[i].item(), rtol=1e-10)
        for name, g in g1.items():
            np.testing.assert_allclose(g.numpy(), grads[name][i].numpy(), rtol=1e-10, atol=1e-12, err_msg=name)
        model.eval()
        batched.eval()
        with torch.no_grad():
            xs = torch.from_numpy(x[:20] + 0.01)
            np.testing.assert_allclose(model(xs).mean.numpy(), batched(xs).mean[i].numpy(), rtol=1e-10, atol=1e-12)
        batched.train()


def test_batched_training_backward_takes_one_fused_pass_per_element(monkeypatch):
    # the symmetric case scales each element's inputs once and passes that one tensor twice:
    # each mBCG backward runs the fused symmetric backward once per element and never the
    # general branch's cotangent of one input (grad_x); the lagged warm start makes the
    # forward one product per element per CG iteration, as in bench.py's recipe
    calls = {"bwd": 0, "grad_x": 0, "product": 0}
    bwd, grad_x, product = fk._bwd_fused_reference, fk._grad_x, fk._product

    def count(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    monkeypatch.setattr(fk, "_bwd_fused_reference", count("bwd", bwd))
    monkeypatch.setattr(fk, "_grad_x", count("grad_x", grad_x))
    monkeypatch.setattr(fk, "_product", count("product", product))
    x, y = _task(700, 2)
    model = _torch_model(x, y, _params(2))
    tx, ty = model.train_inputs[0], model.train_targets
    with _solver_settings(gt.settings, mbcg=True), gt.settings.cg_lagged_rhs(True):
        mll, state = gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)(
            model(tx), ty, base_samples=lambda s: _draw(0, s), solver_state=torch.zeros(2, 700, 1, dtype=torch.float64),
            return_state=True)
        forward_products = calls["product"]
        mll.sum().backward()
    assert calls == {"bwd": 2, "grad_x": 0, "product": forward_products}
    assert forward_products == 2 * state.num_iters


def test_batched_matmul_chunked_matches_a_dense_product():
    # a right-hand side without the operator's batch shape, and a kernel with no fused
    # product, stream through _matmul_chunked by blocks of 4096 rows; against the dense
    # product at 1e-12 relative, and differentiable through each block
    rng = np.random.default_rng(4)
    n = 5000
    x = torch.from_numpy(rng.uniform(size=(n, D)))
    kernel = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D, batch_shape=(2,)), batch_shape=(2,)).double()
    gt.load_jax_params(kernel, {"base_kernel.raw_lengthscale": _params(2)["covar_module.base_kernel.raw_lengthscale"],
                                "raw_outputscale": np.array([0.5, -0.3])})
    op = kernel(x)
    rhs = torch.from_numpy(rng.normal(size=(n, 3)))
    with torch.no_grad():
        dense = op.to_dense()
        out = op._matmul(rhs)  # (n, 3) against a (2, n, n) operator
    assert out.shape == (2, n, 3)
    np.testing.assert_allclose(out.numpy(), (dense @ rhs).numpy(), rtol=1e-12, atol=1e-12 * dense.abs().max().item())
    index = gt.kernels.IndexKernel(num_tasks=3, rank=1).double()  # no fused product
    tasks = torch.from_numpy(rng.integers(0, 3, size=(n, 1)).astype(np.float64))
    iop = index(tasks)
    v = torch.from_numpy(rng.normal(size=(n, 2)))
    np.testing.assert_allclose(iop._matmul(v).detach().numpy(), (iop.to_dense() @ v).detach().numpy(), rtol=1e-12,
                               atol=1e-10)
    (iop._matmul(v) * v).sum().backward()
    assert torch.isfinite(index.covar_factor.grad).all() and index.covar_factor.grad.abs().sum() > 0


def test_batched_pivoted_cholesky_matches_jax_package():
    # per-element pivots and factors of a batch of (3, 60, 60) kernel matrices, and the
    # batched Nyström form on those pivots; 1e-10 relative
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(3, 60, 2))
    ls = np.array([0.2, 0.4, 0.8])[:, None, None]
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    K = np.exp(-0.5 * d2 / ls**2) + 1e-3 * np.eye(60)
    jpc = sys.modules["gpytorch_tpu.solvers.pivoted_cholesky"]
    jL, jpiv = jpc.pivoted_cholesky(gp.linop.DenseLinearOperator(jnp.asarray(K)), 12,
                                                             return_pivots=True)
    tL, tpiv = gt.solvers.pivoted_cholesky(gt.linop.DenseLinearOperator(torch.from_numpy(K)), 12, return_pivots=True)
    np.testing.assert_array_equal(tpiv.numpy(), np.asarray(jpiv))
    np.testing.assert_allclose(tL.numpy(), np.asarray(jL), rtol=1e-10, atol=1e-12)
    jN = jpc.nystrom_factor_from_pivots(gp.linop.DenseLinearOperator(jnp.asarray(K)), jpiv)
    tN = gt.solvers.nystrom_factor_from_pivots(gt.linop.DenseLinearOperator(torch.from_numpy(K)), tpiv)
    np.testing.assert_allclose(tN.numpy(), np.asarray(jN), rtol=1e-10, atol=1e-12)
    # the lazy kernel operator gathers each element's own rows of x1
    kernel = gt.kernels.RBFKernel(batch_shape=(3,)).double()
    kernel.lengthscale = torch.from_numpy(ls)
    lazy = kernel(torch.from_numpy(x))
    np.testing.assert_allclose(lazy._get_rows(tpiv).detach().numpy(), np.take_along_axis(K - 1e-3 * np.eye(60),
                                                                                 tpiv.numpy()[..., None], 1), atol=1e-12)


@functools.lru_cache(maxsize=None)
def _jax_from_batch_mvn():
    n, b = 40, 2
    x, y = _task(n, b)
    jx = jnp.broadcast_to(jnp.asarray(x), (b, n, D))

    @jax.jit
    def log_prob(p, lp):
        jm = _model_class(gp, b)(jx, jnp.asarray(y), gp.likelihoods.GaussianLikelihood(batch_shape=(b,)))
        prior = jm.with_params(p)(jx)
        mt = gp.distributions.MultitaskMultivariateNormal.from_batch_mvn(prior)
        lik = gp.likelihoods.MultitaskGaussianLikelihood(num_tasks=b).with_params(lp)
        marginal = lik(mt)
        return marginal.log_prob(jnp.asarray(y).T), marginal.mean, marginal.variance

    lp = {"raw_task_noises": jnp.asarray([-1.0, -2.0]), "raw_noise": jnp.asarray([-3.0])}
    return tuple(np.asarray(a) for a in log_prob({k: jnp.asarray(v) for k, v in _params(b).items()}, lp))


def test_from_batch_mvn_with_a_multitask_likelihood_matches_jax_package():
    # a batch of 2 GPs read as 2 tasks (interleaved, block-interleaved covariance), under a
    # MultitaskGaussianLikelihood with task and global noise: log_prob, mean and variance
    # at 1e-10 relative (n·t = 80: one dense Cholesky factor)
    want_lp, want_mean, want_var = _jax_from_batch_mvn()
    x, y = _task(40, 2)
    model = _torch_model(x, y, _params(2))
    prior = model(model.train_inputs[0])
    mt = gt.distributions.MultitaskMultivariateNormal.from_batch_mvn(prior)
    lik = gt.load_jax_params(gt.likelihoods.MultitaskGaussianLikelihood(num_tasks=2).double(),
                             {"raw_task_noises": np.array([-1.0, -2.0]), "raw_noise": np.array([-3.0])})
    marginal = lik(mt)
    with torch.no_grad():
        np.testing.assert_allclose(marginal.log_prob(torch.from_numpy(y.T)).item(), want_lp, rtol=1e-10)
        np.testing.assert_allclose(marginal.mean.numpy(), want_mean, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(marginal.variance.numpy(), want_var, rtol=1e-10)


def test_fantasy_model_of_a_batched_model_raises():
    # a batched model conditions each element on its new points (tests/test_torch_fantasy_batched.py
    # holds the values against the JAX package); targets of another batch shape raise
    x, y = _task(50, 2)
    model = _torch_model(x, y, _params(2)).eval()
    with torch.no_grad():
        model(torch.from_numpy(x[:5]))
        with pytest.raises(RuntimeError):
            model.get_fantasy_model(torch.from_numpy(x[:3]), torch.zeros(3, 3, dtype=torch.float64))
        fantasy = model.get_fantasy_model(torch.from_numpy(x[:3]), torch.zeros(2, 3, dtype=torch.float64))
    assert fantasy.prediction_strategy().mean_cache.shape == (2, 53)
