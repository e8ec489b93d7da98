"""The port's online variational conditioning (OVC) against the JAX package, in float64 on
the CPU.

An SVGP (ConstantMean, ScaleKernel(RBFKernel(ard_num_dims=3)), a GaussianLikelihood held
as the model's ``likelihood``) with m = 24 inducing points and a Cholesky q(u) whose
covariance is tighter than the prior's (S ≺ I whitened, S ≺ K_ZZ unwhitened, so that the
pseudo-noise D̃ is positive definite), the same numpy state in both packages
(``load_jax_params`` with ``variational_params_initialized``): each strategy's
``pseudo_points`` (D̃ and ỹ − μ_Z), then the amortized exact GP conditioned on 5 new points
(``get_fantasy_model``), whose predictive mean and variance at 40 test points go against the
JAX package and against dense float64 formulas of the same conditioning (the mean from the
block system [[K_ZZ + D̃, K_Zn], [K_nZ, K_nn + σ²I]] on [ỹ; y_new] − μ, the variances from
K + σ²I on all m + 5 points, as both packages take them).  Everything is below
``max_cholesky_size``, so both packages take dense Cholesky factors.

Tolerance: 1e-10 relative (the same float64 factorisations in another order).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt

D, N, M, N_NEW, N_TEST = 3, 100, 24, 5, 40
RTOL = 1e-10
F64 = jnp.float64


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
    """Float64 distances in JAX (its ``sq_dist`` forms the product in float32 under x64)."""
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)


def _task(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(N, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * x[:, 2] + 0.1 * rng.normal(size=N)
    return x, y


def _state(Z, whitened, seed=3):
    """Raw parameters with q(u)'s factor scaled so that S ≺ I (whitened) or S ≺ K_ZZ."""
    rng = np.random.default_rng(seed)
    m = Z.shape[0]
    L = np.tril(0.1 * rng.normal(size=(m, m)), -1) + np.diag(rng.uniform(0.2, 0.6, size=m))
    params = {"covar_module.raw_outputscale": np.asarray(0.3),
              "covar_module.base_kernel.raw_lengthscale": rng.uniform(-1.5, -0.8, size=(1, D)),
              "mean_module.raw_constant": np.asarray(0.1),
              "likelihood.noise_covar.raw_noise": np.asarray([-3.0]),
              "variational_strategy.inducing_points": Z}
    if whitened:
        L = 0.8 * L / np.linalg.norm(L, 2)
    else:  # S = c·K_root (L L̃ᵀ) K_rootᵀ with the whitened factor's bound
        os_ = np.log1p(np.exp(0.3))
        ls = np.log1p(np.exp(params["covar_module.base_kernel.raw_lengthscale"]))
        d2 = (((Z[:, None, :] - Z[None, :, :]) / ls) ** 2).sum(-1)
        K_root = np.linalg.cholesky(os_ * np.exp(-0.5 * d2) + 1e-6 * np.eye(m))
        L = K_root @ (0.8 * L / np.linalg.norm(L, 2))
    name = "variational_strategy._variational_distribution."
    return params | {name + "variational_mean": rng.normal(size=m), name + "chol_variational_covar": L}


def _pair(whitened):
    x, y = _task()
    Z = x[np.random.default_rng(1).choice(N, M, replace=False)]
    params = _state(Z, whitened)

    def strategy(pkg):
        return pkg.variational.VariationalStrategy if whitened else pkg.variational.UnwhitenedVariationalStrategy

    class JaxSVGP(gp.models.ApproximateGP):
        def __init__(self):
            vd = gp.variational.CholeskyVariationalDistribution(M, dtype=F64)
            super().__init__(strategy(gp)(self, jnp.asarray(Z), vd))
            self.mean_module = gp.means.ConstantMean(dtype=F64)
            self.covar_module = gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=D, dtype=F64), dtype=F64)
            self.likelihood = gp.likelihoods.GaussianLikelihood(dtype=F64)

        def forward(self, xx):
            return gp.distributions.MultivariateNormal(self.mean_module(xx), self.covar_module(xx))

    class TorchSVGP(gt.models.ApproximateGP):
        def __init__(self):
            vd = gt.variational.CholeskyVariationalDistribution(M)
            super().__init__(strategy(gt)(self, torch.from_numpy(Z), vd))
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D))
            self.likelihood = gt.likelihoods.GaussianLikelihood()

        def forward(self, xx):
            return gt.distributions.MultivariateNormal(self.mean_module(xx), self.covar_module(xx))

    jm = JaxSVGP()
    jm(jnp.asarray(x[:4]))  # eager initialisation, then overwritten
    jm = jm.with_params({k: jnp.asarray(v) for k, v in params.items()})
    tm = TorchSVGP().double()
    gt.load_jax_params(tm, {**params, "variational_strategy.variational_params_initialized": 1})
    return jm, tm, x


def _new_points(seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(N_NEW, D)), rng.normal(size=N_NEW), rng.uniform(size=(N_TEST, D))


@pytest.mark.parametrize("whitened", [True, False])
def test_pseudo_points_match_jax(whitened):
    # D̃ (m × m) and ỹ − μ_Z against the JAX package, 1e-10 relative; D̃ symmetric and, for
    # this q(u), positive definite
    jm, tm, _ = _pair(whitened)
    jcov, jmean = jax.jit(lambda: jm.variational_strategy.pseudo_points(jm))()
    with torch.no_grad():
        tcov, tmean = tm.variational_strategy.pseudo_points(tm)
    scale = np.abs(np.asarray(jcov)).max()
    np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), rtol=RTOL, atol=RTOL * scale)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=RTOL, atol=RTOL * np.abs(np.asarray(jmean)).max())
    np.testing.assert_array_equal(tcov.numpy(), tcov.numpy().T)
    assert np.linalg.eigvalsh(tcov.numpy()).min() > 0


def _dense_fantasy(tm, x_new, y_new, x_test):
    """The fantasy's mean and variances from dense float64 formulas, each system with the
    1e-8·I that ``psd_safe_cholesky`` adds in float64 in both packages (the Schur update's
    two factors add it to the whole block system)."""
    with torch.no_grad():
        cov, mean = tm.variational_strategy.pseudo_points(tm)
        Z = tm.variational_strategy.inducing_points
        X = torch.cat([Z, torch.from_numpy(x_new)])
        K = tm.covar_module(X).to_dense()
        mu = tm.mean_module(X)
        noise = tm.likelihood.noise.item()
        A = K.clone()
        A[:M, :M] += cov
        A[M:, M:] += noise * torch.eye(N_NEW, dtype=A.dtype)
        A += 1e-8 * torch.eye(M + N_NEW, dtype=A.dtype)
        targets = torch.cat([mean[:, 0] + tm.mean_module(Z), torch.from_numpy(y_new)])
        xs = torch.from_numpy(x_test)
        K_sx = tm.covar_module(xs, X).to_dense()
        pred_mean = tm.mean_module(xs) + K_sx @ torch.linalg.solve(A, targets - mu)
        K_hat = K + (noise + 1e-8) * torch.eye(M + N_NEW, dtype=K.dtype)
        pred_var = tm.covar_module(xs, diag=True) - (K_sx * torch.linalg.solve(K_hat, K_sx.mT).mT).sum(-1)
    return pred_mean.numpy(), pred_var.numpy()


@pytest.mark.parametrize("whitened", [True, False])
def test_fantasy_model_matches_jax_and_dense(whitened):
    # the amortized exact GP conditioned on 5 new points, at 40 test points: mean and
    # variance against the JAX package and the dense float64 formulas, 1e-10 relative; the
    # model's get_fantasy_model is the strategy's
    jm, tm, _ = _pair(whitened)
    x_new, y_new, x_test = _new_points()
    # already in eval mode (``eval()`` would clear the JAX model's caches, the Schur update's)
    jf = jm.variational_strategy.get_fantasy_model(jnp.asarray(x_new), jnp.asarray(y_new), model=jm)
    jout = jax.jit(lambda xx: (jf(xx).mean, jf(xx).variance))(jnp.asarray(x_test))
    with torch.no_grad():
        tf = tm.get_fantasy_model(torch.from_numpy(x_new), torch.from_numpy(y_new))
        tout = tf(torch.from_numpy(x_test))
        t_mean, t_var = tout.mean.numpy(), tout.variance.numpy()
    assert isinstance(tf, gt.models.ExactGP) and tf.train_inputs[0].shape == (M + N_NEW, D)
    np.testing.assert_allclose(t_mean, np.asarray(jout[0]), rtol=RTOL, atol=RTOL * np.abs(t_mean).max())
    np.testing.assert_allclose(t_var, np.asarray(jout[1]), rtol=RTOL, atol=RTOL * np.abs(t_var).max())
    d_mean, d_var = _dense_fantasy(tm, x_new, y_new, x_test)
    np.testing.assert_allclose(t_mean, d_mean, rtol=RTOL, atol=RTOL * np.abs(d_mean).max())
    np.testing.assert_allclose(t_var, d_var, rtol=RTOL, atol=RTOL * np.abs(d_var).max())


def test_amortized_exact_gp_reproduces_the_variational_mean():
    # before any new point, the exact GP over (Z, ỹ) with noise D̃ predicts the whitened
    # SVGP's own mean up to the jitter ε of the normal equations (R Rᵀ + εI): 1e-3 relative
    # at the strategy's default float64 jitter 1e-6 (7e-5 read; 2e-8 at ε = 1e-10)
    _, tm, _ = _pair(True)
    _, _, x_test = _new_points()
    xs = torch.from_numpy(x_test)
    with torch.no_grad():
        tm.eval()
        svgp_mean = tm(xs).mean.numpy()
        exact_mean = tm.variational_strategy.amortized_exact_gp(model=tm)(xs).mean.numpy()
    np.testing.assert_allclose(exact_mean, svgp_mean, rtol=1e-3, atol=1e-3 * np.abs(svgp_mean).max())


def test_fantasy_needs_a_cholesky_q():
    # a mean-field q(u) has no pseudo-points: NotImplementedError in both methods
    x, _ = _task()
    Z = torch.from_numpy(x[:M])

    class TorchSVGP(gt.models.ApproximateGP):
        def __init__(self):
            vd = gt.variational.MeanFieldVariationalDistribution(M)
            super().__init__(gt.variational.VariationalStrategy(self, Z, vd))
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel())

        def forward(self, xx):
            return gt.distributions.MultivariateNormal(self.mean_module(xx), self.covar_module(xx))

    model = TorchSVGP().double()
    with pytest.raises(NotImplementedError):
        model.get_fantasy_model(Z[:2], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        model.variational_strategy.pseudo_points(model)
