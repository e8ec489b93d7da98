"""The port's SGPR (``InducingPointKernel``) and random-Fourier-feature (``RFFKernel``) exact
GPs against the JAX package, in float64 on the CPU.

On 96 points of a 2-input task: an exact GP with ConstantMean and
InducingPointKernel(ScaleKernel(RBFKernel(ard_num_dims=2)), 16 inducing points), and one with
RFFKernel(num_samples=8, ard_num_dims=2), bare and inside a ScaleKernel.  The exact MLL (with
SGPR's added loss term) and its gradient in every parameter against ``jax.grad``, by the
dense Cholesky factor (n ≤ 800) and under ``max_cholesky_size(0)`` by mBCG with probes
injected into both packages by shape; the predictive mean and variance of 20 points; which
prediction strategy each kernel selects, and whether it serves from its feature-space
caches; each added-loss-term class's ``loss``.  The JAX package keeps the likelihood a
second time under the SGPR kernel (``covar_module.likelihood.*``), as a leaf of its own: the
port's one noise parameter takes the sum of the two JAX gradients.  RFF's frequencies
(``randn_weights``) come across by ``load_jax_params``.

Tolerance: 1e-8 relative (the same float64 arithmetic in another order; mBCG at tolerance
1e-12 with 100 Lanczos iterations, more than n).
"""

import contextlib
import copy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu.linop.base
import gpytorch_tpu_torch as gt
import gpytorch_tpu_torch.linop.base

D, N, M, S = 2, 96, 16, 8
RTOL = 1e-8
F64 = jnp.float64
DUP = "covar_module.likelihood.noise_covar.raw_noise"


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


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    monkeypatch.setattr(gpytorch_tpu.linop.base, "probe_base_samples",
                        lambda key, shape, dtype: jnp.asarray(_draw(7, tuple(shape)), dtype=dtype))
    monkeypatch.setattr(gpytorch_tpu_torch.linop.base, "probe_base_samples",
                        lambda shape, dtype, device, source=None: torch.from_numpy(_draw(7, tuple(shape))).to(dtype))


def _mbcg(mod):
    stack = contextlib.ExitStack()
    for ctx in (mod.max_cholesky_size(0), mod.max_cg_iterations(500), mod.cg_tolerance(1e-12),
                mod.eval_cg_tolerance(1e-12), mod.num_trace_samples(6), mod.max_lanczos_quadrature_iterations(100)):
        stack.enter_context(ctx)
    return stack


def _no_settings(mod):
    return contextlib.ExitStack()


def _task(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(N + 20, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.1 * rng.normal(size=N + 20)
    return x[:N], y[:N], x[N:]


def _model(pkg, kind, x, y):
    kw = {"dtype": F64} if pkg is gp else {}
    arr = jnp.asarray if pkg is gp else torch.from_numpy
    lik = pkg.likelihoods.GaussianLikelihood(**kw)

    class Exact(pkg.models.ExactGP):
        def __init__(self):
            super().__init__(arr(x), arr(y), lik)
            self.mean_module = pkg.means.ConstantMean(**kw)
            if kind == "sgpr":
                base = pkg.kernels.ScaleKernel(pkg.kernels.RBFKernel(ard_num_dims=D, **kw), **kw)
                self.covar_module = pkg.kernels.InducingPointKernel(base, arr(x[::N // M]), lik, **kw)
            else:
                rff = pkg.kernels.RFFKernel(num_samples=S, num_dims=D, ard_num_dims=D, **kw)
                self.covar_module = pkg.kernels.ScaleKernel(rff, **kw) if kind == "scaled_rff" else rff

        def forward(self, x):
            return pkg.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    return Exact()


def _pair(kind):
    x, y, _ = _task()
    jm = _model(gp, kind, x, y)
    rng = np.random.default_rng(4)
    params = {k: np.asarray(v, dtype=np.float64) + (0.05 if k.endswith("inducing_points") else 0.3)
              * rng.normal(size=np.shape(v)) for k, v in jm.trainable_params().items()}
    if DUP in params:
        params[DUP] = params["likelihood.noise_covar.raw_noise"]
    jm = jm.with_params({k: jnp.asarray(v) for k, v in params.items()})
    tm = _model(gt, kind, x, y).double()
    state = {k: v for k, v in params.items()}
    if kind != "sgpr":
        path = "covar_module.base_kernel" if kind == "scaled_rff" else "covar_module"
        kernel = jm.covar_module.base_kernel if kind == "scaled_rff" else jm.covar_module
        state[f"{path}.randn_weights"] = np.asarray(kernel.randn_weights)
    gt.load_jax_params(tm, state)
    return jm, tm, params


@pytest.mark.parametrize("path", ["cholesky", "mbcg"])
@pytest.mark.parametrize("kind", ["sgpr", "rff", "scaled_rff"])
def test_mll_and_gradients_match_jax(kind, path):
    # the exact MLL (SGPR: with its variance-correction term) and its gradient in every
    # parameter against jax.grad, 1e-8 relative to the largest gradient; the port's one
    # noise parameter against the sum of the JAX package's two copies
    x, y, _ = _task()
    jm, tm, params = _pair(kind)
    settings = _mbcg if path == "mbcg" else _no_settings

    def f(p, x, y):
        m = jm.with_params(p)
        return gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(x), y)

    with settings(gp.settings):
        jval, jgrad = jax.jit(jax.value_and_grad(f))({k: jnp.asarray(v) for k, v in params.items()},
                                                     jnp.asarray(x), jnp.asarray(y))
    tm.train()
    with settings(gt.settings):
        val = gt.mlls.ExactMarginalLogLikelihood(tm.likelihood, tm)(tm(torch.from_numpy(x)), torch.from_numpy(y))
        val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=RTOL)
    jgrad = {k: np.asarray(g) for k, g in jgrad.items()}
    if DUP in jgrad:
        jgrad["likelihood.noise_covar.raw_noise"] = jgrad["likelihood.noise_covar.raw_noise"] + jgrad.pop(DUP)
    tgrad = {k: q.grad.numpy() for k, q in tm.named_parameters()}
    assert set(tgrad) == set(jgrad)
    scale = max(np.abs(g).max() for g in jgrad.values())
    for k, g in jgrad.items():
        np.testing.assert_allclose(tgrad[k], g, rtol=RTOL, atol=RTOL * scale, err_msg=k)


@pytest.mark.parametrize("path", ["cholesky", "mbcg"])
@pytest.mark.parametrize("kind", ["sgpr", "rff", "scaled_rff"])
def test_predictions_and_selected_strategy_match_jax(kind, path):
    # eval mode, 20 test points: the predictive mean and variance against the JAX package's,
    # 1e-8 relative; SGPR selects SGPRPredictionStrategy, RFF LinearPredictionStrategy in both
    # packages; bare RFF serves from its feature-space caches, a ScaleKernel around it by the
    # default strategy's math (the scaled root is no root), in both packages
    _, _, xs = _task()
    jm, tm, _ = _pair(kind)
    settings = _mbcg if path == "mbcg" else _no_settings
    jm = jm.eval()
    with settings(gp.settings):
        out = jm(jnp.asarray(xs))
        jmean, jvar = np.asarray(out.mean), np.asarray(out.variance)
    tm.eval()
    with settings(gt.settings), torch.no_grad():
        pred = tm(torch.from_numpy(xs))
        tmean, tvar = pred.mean.numpy(), pred.variance.numpy()
    np.testing.assert_allclose(tmean, jmean, rtol=RTOL, atol=RTOL * np.abs(jmean).max())
    np.testing.assert_allclose(tvar, jvar, rtol=RTOL, atol=RTOL * np.abs(jvar).max())
    j_strategy, t_strategy = jm._cache["prediction_strategy"], tm._cache["prediction_strategy"]
    want = "SGPRPredictionStrategy" if kind == "sgpr" else "LinearPredictionStrategy"
    assert type(j_strategy).__name__ == type(t_strategy).__name__ == want
    if kind != "sgpr":
        feature_path = kind == "rff"
        assert (j_strategy._feat_mean_cache is not None) == feature_path
        assert (t_strategy._feat_mean_cache is not None) == feature_path
        assert (t_strategy._mean_cache is None) == feature_path


def test_skip_posterior_variances_on_the_feature_path():
    # bare RFF under skip_posterior_variances: a zero covariance on the features' device and
    # dtype, the same mean
    _, _, xs = _task()
    _, tm, _ = _pair("rff")
    tm.eval()
    with torch.no_grad():
        mean = tm(torch.from_numpy(xs)).mean
        with gt.settings.skip_posterior_variances(True):
            out = tm(torch.from_numpy(xs))
    cov = out.lazy_covariance_matrix
    assert isinstance(cov, gt.linop.ZeroLinearOperator) and cov.device == mean.device and cov.dtype == mean.dtype
    np.testing.assert_allclose(out.mean.numpy(), mean.numpy(), rtol=1e-12)


def test_sgpr_loss_term_is_set_in_training_and_cleared_in_eval():
    # a training call sets the kernel's term; eval() clears it, so an MLL taken in eval mode
    # adds none; a deep copy (the float64 twin's way) leaves it behind and works
    x, y, _ = _task()
    _, tm, _ = _pair("sgpr")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    tm.train()
    mll = gt.mlls.ExactMarginalLogLikelihood(tm.likelihood, tm)
    with_term = mll(tm(tx), ty)
    terms = list(tm.added_loss_terms())
    assert len(terms) == 1
    twin = copy.deepcopy(tm)
    assert not list(twin.added_loss_terms())
    tm.eval()
    assert not list(tm.added_loss_terms())
    without = mll(tm.forward(tx), ty)
    np.testing.assert_allclose(with_term.item() - without.item(), terms[0].loss().item() / N, rtol=1e-10)


def test_added_loss_terms_match_jax():
    # each added-loss-term class's loss on the same inputs, 1e-12 relative
    rng = np.random.default_rng(8)
    k_diag, q_diag = rng.uniform(1.0, 2.0, 12), rng.uniform(0.2, 0.9, 12)
    jl = gp.likelihoods.GaussianLikelihood(dtype=F64).with_params({"noise_covar.raw_noise": jnp.asarray([-1.0])})
    tl = gt.likelihoods.GaussianLikelihood().double()
    gt.load_jax_params(tl, {"noise_covar.raw_noise": np.asarray([-1.0])})
    zeros = np.zeros(12)

    def mvns(pkg, arr, diag_op):
        return [pkg.distributions.MultivariateNormal(arr(zeros), diag_op(arr(d))) for d in (k_diag, q_diag)]

    j_term = gp.mlls.added_loss_term.InducingPointKernelAddedLossTerm(
        *mvns(gp, jnp.asarray, gp.linop.DiagLinearOperator), jl)
    t_term = gt.mlls.InducingPointKernelAddedLossTerm(*mvns(gt, torch.from_numpy, gt.linop.DiagLinearOperator), tl)
    np.testing.assert_allclose(t_term.loss().item(), float(j_term.loss()), rtol=1e-12)
    noise = tl.noise.item()
    np.testing.assert_allclose(t_term.loss().item(), -0.5 * np.sum((k_diag - q_diag) / noise), rtol=1e-12)

    mq, vq, mp, vp = (rng.normal(size=(10, 3)), rng.uniform(0.5, 1.5, (10, 3)), rng.normal(size=(10, 3)),
                      rng.uniform(0.5, 1.5, (10, 3)))

    class _Diag:
        def __init__(self, mean, var):
            self.mean, self.variance = mean, var

    j_kl = gp.mlls.added_loss_term.KLGaussianAddedLossTerm(_Diag(jnp.asarray(mq), jnp.asarray(vq)),
                                                           _Diag(jnp.asarray(mp), jnp.asarray(vp)), 10, 3)
    t_kl = gt.mlls.KLGaussianAddedLossTerm(_Diag(torch.from_numpy(mq), torch.from_numpy(vq)),
                                           _Diag(torch.from_numpy(mp), torch.from_numpy(vp)), 10, 3)
    # the port divides Σ KL by n · data_dim (GPyTorch's); the JAX package by n, data_dim times more
    np.testing.assert_allclose(3 * t_kl.loss().item(), float(j_kl.loss()), rtol=1e-12)
    np.testing.assert_allclose(t_kl.loss().item(), float(np.sum(0.5 * (np.log(vp / vq) + (vq + (mq - mp) ** 2) / vp
                                                                       - 1.0))) / (10 * 3), rtol=1e-12)

    xs, ys = rng.normal(size=5), rng.normal(size=5)
    j_nm = gp.mlls.added_loss_term.NoiseModelAddedLossTerm(lambda x: 2.0 * x, lambda out, t: -(out - t) ** 2)
    t_nm = gt.mlls.NoiseModelAddedLossTerm(lambda x: 2.0 * x, lambda out, t: -(out - t) ** 2)
    np.testing.assert_allclose(t_nm.loss(torch.from_numpy(xs), torch.from_numpy(ys)).item(),
                               float(j_nm.loss(jnp.asarray(xs), jnp.asarray(ys))), rtol=1e-12)
    assert isinstance(t_term, gt.mlls.AddedLossTerm)
