"""The port's dense-Cholesky path against the JAX package, in float64 on the CPU.

Up to ``settings.max_cholesky_size`` (800) points, or at any size with
``settings.fast_computations`` off, ``solve``, both root decompositions and
``inv_quad_logdet`` take a dense Cholesky factor with escalating jitter instead of CG and
Lanczos, in both packages.  At N=300 under the default settings: the solve, the two
roots, and the exact and LOVE (``fast_pred_var``) posteriors; at N=900 under
``fast_computations(False, False, False)``: the solve and the log density; and training
on BASELINE config 1's 1D toy through the Cholesky MLL.  The same numpy data and raw
parameters go through both packages, with the JAX package's distances in float64
(``_exact_float64_sq_dist``).

Tolerance: 1e-9 relative (the same factorisations; differences near 1e-13 from the order
of float64 operations).
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt
from gpytorch_tpu.models import ExactGP as JaxExactGP

N, M, D = 300, 40, 3
RTOL = 1e-9
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


def _exact_float64_sq_dist(x1, x2, x1_eq_x2=False):
    # gpytorch_tpu's sq_dist forms its distance product in float32 even under x64
    adj = jnp.mean(x1, axis=-2, keepdims=True)
    x1, x2 = x1 - adj, x2 - adj
    res = (-2.0 * jnp.matmul(x1, jnp.swapaxes(x2, -1, -2), precision=jax.lax.Precision.HIGHEST)
           + jnp.sum(x1 * x1, -1, keepdims=True) + jnp.swapaxes(jnp.sum(x2 * x2, -1, keepdims=True), -1, -2))
    if x1_eq_x2:
        res = res * (1.0 - jnp.eye(res.shape[-1], dtype=res.dtype))
    return jnp.maximum(res, 0.0)


@pytest.fixture(autouse=True)
def _float64_distances(monkeypatch):
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)


def _task(n, m, d=D, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n + m, d))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, -1]) + 0.1 * rng.normal(size=n + m)
    y = (y - y.mean()) / y.std()
    return x[:n], y[:n], x[n:], y[n:]


class JaxModel(JaxExactGP):
    def __init__(self, x, y, likelihood):
        super().__init__(x, y, likelihood)
        self.mean_module = gp.means.ConstantMean()
        self.covar_module = gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=x.shape[-1]))

    def forward(self, x):
        return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


class TorchModel(gt.models.ExactGP):
    def __init__(self, x, y, likelihood):
        super().__init__(x, y, likelihood)
        self.mean_module = gt.means.ConstantMean()
        self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=x.shape[-1]))

    def forward(self, x):
        return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


def _models(n, m=M):
    train_x, train_y, test_x, test_y = _task(n, m)
    jm = JaxModel(jnp.asarray(train_x), jnp.asarray(train_y), gp.likelihoods.GaussianLikelihood())
    jm = jm.with_params({k: jnp.asarray(v) for k, v in PARAMS.items()})
    tm = TorchModel(torch.from_numpy(train_x), torch.from_numpy(train_y), gt.likelihoods.GaussianLikelihood()).double()
    return jm, gt.load_jax_params(tm, PARAMS), test_x


def _covariances(n):
    """K̂ = K + σ²I of both packages (the marginal over the training data), and a rhs."""
    jm, tm, _ = _models(n)
    x = jm.train_inputs[0]
    jcov = jm.likelihood(jm.train().forward(x)).lazy_covariance_matrix
    tcov = tm.likelihood(tm.train().forward(tm.train_inputs[0])).lazy_covariance_matrix
    rhs = np.random.default_rng(4).normal(size=(n, 3))
    return jcov, tcov, rhs


def test_solve_takes_the_cholesky_branch():
    jcov, tcov, rhs = _covariances(N)
    want = np.asarray(jax.jit(lambda b: jcov.solve(b))(jnp.asarray(rhs)))
    with torch.no_grad():
        got = tcov.solve(torch.from_numpy(rhs))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    assert tcov.evaluate_kernel().last_cg_result is None  # no CG ran
    # the dense solve's residual is the base jitter's, 1e-8 x, plus float64 round-off
    with torch.no_grad():
        res = tcov.matmul(got) - torch.from_numpy(rhs)
    assert res.abs().max().item() <= 1.5e-8 * got.abs().max().item()


@pytest.mark.parametrize("inverse", [False, True], ids=["root", "root_inv"])
def test_root_decompositions_take_the_cholesky_branch(inverse):
    jcov, tcov, _ = _covariances(N)
    name = "root_inv_decomposition" if inverse else "root_decomposition"
    want = np.asarray(jax.jit(lambda: getattr(jcov, name)().to_dense())())
    with torch.no_grad():
        root = getattr(tcov, name)()
        got = root.to_dense().numpy()
    assert root.root.shape == (N, N)  # the full factor, not a Lanczos rank
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("fast_pred_var", [False, True], ids=["exact", "love"])
def test_posterior_at_default_settings_matches_jax_package(fast_pred_var):
    jm, tm, test_x = _models(N)

    @jax.jit
    def jax_predict(tx):
        with gp.settings.fast_pred_var(fast_pred_var):
            pred = jm.eval()(tx)
            return pred.mean, pred.variance

    jmean, jvar = (np.asarray(a) for a in jax_predict(jnp.asarray(test_x)))
    tm.eval()
    with gt.settings.fast_pred_var(fast_pred_var), torch.no_grad():
        pred = tm(torch.from_numpy(test_x))
        tmean, tvar = pred.mean.numpy(), pred.variance.numpy()
    strategy = tm.prediction_strategy()
    assert strategy.lik_train_train_covar.last_cg_result is None  # the mean cache by Cholesky
    np.testing.assert_allclose(tmean, jmean, rtol=RTOL, atol=RTOL * np.abs(jmean).max())
    np.testing.assert_allclose(tvar, jvar, rtol=RTOL, atol=1e-12)
    if fast_pred_var:  # the LOVE cache is the full inverse Cholesky root, not a rank-100 Lanczos one
        assert strategy.covar_cache.shape == (N, N)


def test_fast_computations_off_takes_the_cholesky_branch_above_max_cholesky_size():
    n = 900
    jcov, tcov, rhs = _covariances(n)
    y = rhs[:, 0]

    @jax.jit
    def jax_side(b, yy):
        with gp.settings.fast_computations(False, False, False):
            dist = gp.distributions.MultivariateNormal(jnp.zeros(n), jcov)
            return jcov.solve(b), dist.log_prob(yy)

    want_solve, want_lp = (np.asarray(a) for a in jax_side(jnp.asarray(rhs), jnp.asarray(y)))
    with gt.settings.fast_computations(False, False, False), torch.no_grad():
        got_solve = tcov.solve(torch.from_numpy(rhs)).numpy()
        dist = gt.distributions.MultivariateNormal(torch.zeros(n, dtype=torch.float64), tcov)
        got_lp = dist.log_prob(torch.from_numpy(y)).item()
        root = tcov.root_decomposition()
    assert root.root.shape == (n, n)
    np.testing.assert_allclose(got_solve, want_solve, rtol=RTOL, atol=RTOL * np.abs(want_solve).max())
    np.testing.assert_allclose(got_lp, float(want_lp), rtol=RTOL)
    # each flag alone: log_prob off takes the dense log density, solves stays iterative
    with gt.settings.fast_computations(log_prob=False), gt.settings.max_cg_iterations(5), torch.no_grad():
        assert tcov._use_cholesky() is False
        np.testing.assert_allclose(dist.log_prob(torch.from_numpy(y)).item(), float(want_lp), rtol=RTOL)


def test_the_iterative_only_guard_is_gone():
    assert not hasattr(gt.linop.LinearOperator, "_check_iterative")


def test_triangular_operators():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(6, 6))
    A = torch.from_numpy(a @ a.T + 6 * np.eye(6))
    L = torch.linalg.cholesky(A)
    b = torch.from_numpy(rng.normal(size=(6, 2)))
    chol = gt.linop.CholLinearOperator(L)
    torch.testing.assert_close(chol.to_dense(), A, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(chol.solve(b), torch.linalg.solve(A, b), rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(chol.root_inv_decomposition().to_dense(), torch.linalg.inv(A), rtol=1e-10, atol=1e-12)
    tri = gt.linop.TriangularLinearOperator(L)
    torch.testing.assert_close(tri.solve(b), torch.linalg.solve(L, b), rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(tri.inverse().to_dense() @ L, torch.eye(6, dtype=torch.float64), rtol=0, atol=1e-12)
    # cholesky() factors A + 1e-8 I, psd_safe_cholesky's float64 base jitter
    upper = gt.linop.DenseLinearOperator(A).cholesky(upper=True)
    L_jittered = torch.linalg.cholesky(A + 1e-8 * torch.eye(6, dtype=torch.float64))
    torch.testing.assert_close(upper.solve(b), torch.linalg.solve(L_jittered.mT, b), rtol=1e-10, atol=1e-12)


TOY_N, TOY_STEPS = 200, 5


@functools.lru_cache(maxsize=None)
def _toy():
    """BASELINE config 1 at a reduced N: y = sin 2πx + 0.1 noise on [0, 1]."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(TOY_N, 1))
    return x, np.sin(2 * np.pi * x[:, 0]) + 0.1 * rng.normal(size=TOY_N)


def test_cholesky_training_on_the_1d_toy_matches_jax_package():
    # Adam at lr 0.1 through the Cholesky MLL under fast_computations(False, False, False)
    x, y = _toy()
    jm = JaxModel(jnp.asarray(x), jnp.asarray(y), gp.likelihoods.GaussianLikelihood())
    # the JAX package's initial raw parameters (zeros) in float64, as the port's
    params = {k: jnp.asarray(np.asarray(v, dtype=np.float64)) for k, v in jm.trainable_params().items()}
    opt = optax.adam(0.1)
    opt_state = opt.init(params)

    @jax.jit
    def step(p, s):
        def loss(p):
            m = jm.with_params(p)
            with gp.settings.fast_computations(False, False, False):
                return -gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(m.train_inputs[0]), m.train_targets)

        value, grads = jax.value_and_grad(loss)(p)
        updates, s = opt.update(grads, s)
        return optax.apply_updates(p, updates), s, value

    tm = TorchModel(torch.from_numpy(x), torch.from_numpy(y), gt.likelihoods.GaussianLikelihood()).double()
    gt.load_jax_params(tm, {k: np.asarray(v) for k, v in params.items()})
    topt = torch.optim.Adam(tm.parameters(), lr=0.1)
    for i in range(TOY_STEPS):
        params, opt_state, jloss = step(params, opt_state)
        topt.zero_grad()
        with gt.settings.fast_computations(False, False, False):
            tloss = -gt.mlls.ExactMarginalLogLikelihood(tm.likelihood, tm)(tm(tm.train_inputs[0]), tm.train_targets)
        tloss.backward()
        topt.step()
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL, err_msg=f"step {i}")
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[name]), rtol=1e-8, atol=1e-10, err_msg=name)


def _ill_conditioned(n=200, seed=0):
    """RBF(ℓ = 0.5) on n uniform points in the unit cube plus 1e-4·I: cond ≈ 1e6."""
    x = np.random.default_rng(seed).uniform(size=(n, D))
    return np.exp(-0.5 * ((x[:, None] - x[None]) ** 2).sum(-1) / 0.5**2) + 1e-4 * np.eye(n)


def test_float32_cholesky_is_promoted_to_float64_as_in_the_jax_package():
    # settings._linalg_dtype_cholesky (float64 by default): a float32 matrix is factored in
    # float64 with float64's jitter (1e-8) and the factor cast back, as the JAX package does
    # under x64.  The two factors agree to 1e-9 of max |L| (they read 1.5e-11 apart; a
    # float32 factorisation reads 2e-4 apart), and under _linalg_dtype_cholesky(None) the
    # port factors in float32 again
    a = _ill_conditioned()
    want = np.asarray(gp.solvers.psd_safe_cholesky(jnp.asarray(a, dtype=jnp.float32)))
    got = gt.solvers.psd_safe_cholesky(torch.as_tensor(a, dtype=torch.float32))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-9 * np.abs(want).max()
    with gt.settings._linalg_dtype_cholesky(None):
        f32 = gt.solvers.psd_safe_cholesky(torch.as_tensor(a, dtype=torch.float32)).numpy()
    assert np.abs(f32 - want).max() > 1e-6 * np.abs(want).max()


def _unwhitened_svgp(pkg, z, dtype):
    m = z.shape[0]
    if pkg is gp:
        zj = jnp.asarray(z, dtype=dtype)

        class JaxSVGP(gp.models.ApproximateGP):
            def __init__(self):
                vd = gp.variational.CholeskyVariationalDistribution(m, dtype=dtype)
                super().__init__(gp.variational.UnwhitenedVariationalStrategy(self, zj, vd, jitter_val=1e-4))
                self.mean_module = gp.means.ConstantMean(dtype=dtype)
                self.covar_module = gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=D, dtype=dtype),
                                                           dtype=dtype)

            def forward(self, x):
                return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

        model = JaxSVGP()
        model(zj[:4])  # q(u) initialises eagerly, then is overwritten
        return model

    class TorchSVGP(gt.models.ApproximateGP):
        def __init__(self):
            super().__init__(gt.variational.UnwhitenedVariationalStrategy(
                self, torch.as_tensor(z), gt.variational.CholeskyVariationalDistribution(m), jitter_val=1e-4))
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D))

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    return TorchSVGP().to(dtype=dtype)


def test_unwhitened_kl_in_float32_by_dense_cholesky_matches_jax_package():
    # the unwhitened KL(q(u) ‖ N(μ_Z, K_ZZ + 1e-4·I)) at m = 256 on the dense-Cholesky path in
    # float32, both packages from one state: within 1e-3 of each other (they read 3.2e-4
    # apart; with the port's factors in float32 1e-2) and of the float64 value
    m = 256
    rng = np.random.default_rng(1)
    z = rng.uniform(size=(m, D))
    vd = "variational_strategy._variational_distribution."
    params = {"variational_strategy.inducing_points": z, vd + "variational_mean": rng.normal(size=m),
              vd + "chol_variational_covar": np.tril(rng.normal(size=(m, m)) * 0.01) + 0.3 * np.eye(m),
              "mean_module.raw_constant": np.array(0.1), "covar_module.raw_outputscale": np.array(0.0),
              "covar_module.base_kernel.raw_lengthscale": np.zeros((1, D))}
    kl = {}
    for name, dtype, jdt in (("float32", torch.float32, jnp.float32), ("float64", torch.float64, jnp.float64)):
        jm = _unwhitened_svgp(gp, z, jdt).with_params({k: jnp.asarray(v, dtype=jdt) for k, v in params.items()})
        with gp.settings.max_cholesky_size(m):
            kl["jax", name] = float(jax.jit(lambda: jm.variational_strategy.kl_divergence(model=jm))())
        tm = gt.load_jax_params(_unwhitened_svgp(gt, z, dtype),
                                params | {"variational_strategy.variational_params_initialized": 1})
        with torch.no_grad(), gt.settings.max_cholesky_size(m):
            kl["port", name] = tm.variational_strategy.kl_divergence(model=tm).item()
    np.testing.assert_allclose(kl["port", "float64"], kl["jax", "float64"], rtol=1e-9)
    np.testing.assert_allclose(kl["port", "float32"], kl["jax", "float32"], rtol=1e-3)
    np.testing.assert_allclose(kl["port", "float32"], kl["jax", "float64"], rtol=1e-3)
