"""The port's LOVE posterior sampling (``settings.fast_pred_samples``) against the JAX
package, in float64 on the CPU.

Under ``fast_pred_samples`` the predictive covariance is its own Lanczos root R_s:
R_s R_sᵀ ≈ K** − (K*x R)(K*x R)ᵀ, R the LOVE inverse root of the training covariance, and
a draw is μ* + R_s u.  The same numpy data, raw parameters, Lanczos start blocks (keyed by
their shape; injected into both packages by replacing each one's ``_block_init``) and base
samples go through both packages: the JAX package's base samples by replacing
``gpytorch_tpu.linop.root.probe_base_samples``, the port's through ``base_samples``.  The
LOVE cache comes from a dense Cholesky factor at the default settings (N=300 ≤
max_cholesky_size) and from block Lanczos under max_cholesky_size(0).

Tolerance: 1e-9 relative to the largest entry (the same Lanczos arithmetic in another
order; R_s R_sᵀ read 5e-14 and the draws 5e-13 of their largest entries, the posterior
covariance's eigenvalues lying in [2e-4, 6e-2]).
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
from gpytorch_tpu.models import ExactGP as JaxExactGP

N, M, D, SAMPLES = 300, 40, 3, 16
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


def _task(n, m, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n + m, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * np.sin(7 * x[:, 2] * x[:, 0]) + 0.1 * rng.normal(size=n + m)
    y = (y - y.mean()) / y.std()
    return x[:n], y[:n], x[n:]


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
    # gpytorch_tpu's sq_dist forms its distance product in float32 even under x64
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


def _settings(mod, lanczos_caches):
    stack = contextlib.ExitStack()
    stack.enter_context(mod.fast_pred_samples(True))
    if lanczos_caches:
        # test_torch_exact_serving.py's serving settings, under which both packages' CG
        # takes the same iterations
        for ctx in (mod.max_cholesky_size(0), mod.min_preconditioning_size(0), mod.max_preconditioner_size(50),
                    mod.preconditioner_noise_budget(1e-3), mod.eval_cg_tolerance(1e-3), mod.cg_stall_window(50)):
            stack.enter_context(ctx)
    return stack


@pytest.fixture
def injected(monkeypatch):
    """Start blocks into both packages, base samples and float64 distances into JAX."""
    monkeypatch.setattr(gpytorch_tpu.solvers.lanczos, "_block_init",
                        lambda linop, iv, b: jnp.asarray(_start_block(linop.shape[-1], b)))
    monkeypatch.setattr(gpytorch_tpu_torch.solvers.lanczos, "_block_init",
                        lambda linop, iv, b: torch.from_numpy(_start_block(linop.shape[-1], b)))
    monkeypatch.setattr(gpytorch_tpu.linop.root, "probe_base_samples",
                        lambda key, shape, dtype: jnp.asarray(_base_draw(tuple(shape)), dtype=dtype))
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)


@functools.lru_cache(maxsize=None)
def _jax_sampled(lanczos_caches):
    """The JAX package's posterior under fast_pred_samples: R_s R_sᵀ, a draw from given
    base samples, an rsample with injected base samples, and the mean."""
    train_x, train_y, test_x = _task(N, M)
    u = _base_draw((SAMPLES, 100))

    @jax.jit
    def sampled(params, tx, base):
        jm = JaxModel(jnp.asarray(train_x), jnp.asarray(train_y), gp.likelihoods.GaussianLikelihood())
        jm = jm.with_params(params).eval()
        with _settings(gp.settings, lanczos_caches):
            post = jm(tx)
            k = post.lazy_covariance_matrix.root.shape[-1]
            return (post.covariance_matrix, post.rsample_from_base_samples(base[:, :k]),
                    post.rsample(jax.random.PRNGKey(0), (SAMPLES,)), post.mean, k)

    params = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    cov, from_base, draws, mean, k = sampled(params, jnp.asarray(test_x), jnp.asarray(u))
    return dict(cov=np.asarray(cov), from_base=np.asarray(from_base), draws=np.asarray(draws), mean=np.asarray(mean),
                k=int(k), u=u)


def _torch_posterior(lanczos_caches):
    train_x, train_y, test_x = _task(N, M)
    tm = TorchModel(torch.from_numpy(train_x), torch.from_numpy(train_y), gt.likelihoods.GaussianLikelihood()).double()
    gt.load_jax_params(tm, PARAMS).eval()
    with _settings(gt.settings, lanczos_caches), torch.no_grad():
        return tm(torch.from_numpy(test_x))


@pytest.mark.parametrize("lanczos_caches", [False, True], ids=["cholesky_cache", "lanczos_cache"])
def test_sample_root_matches_jax_package(injected, lanczos_caches):
    want = _jax_sampled(lanczos_caches)
    post = _torch_posterior(lanczos_caches)
    root = post.lazy_covariance_matrix
    assert isinstance(root, gt.linop.RootLinearOperator) and root.root.shape == (M, want["k"])
    got = root.to_dense().numpy()
    np.testing.assert_allclose(got, want["cov"], rtol=RTOL, atol=RTOL * np.abs(want["cov"]).max())
    np.testing.assert_allclose(post.mean.numpy(), want["mean"], rtol=1e-9, atol=1e-9 * np.abs(want["mean"]).max())


@pytest.mark.parametrize("lanczos_caches", [False, True], ids=["cholesky_cache", "lanczos_cache"])
def test_samples_match_jax_package(injected, lanczos_caches):
    want = _jax_sampled(lanczos_caches)
    post = _torch_posterior(lanczos_caches)
    u = torch.from_numpy(want["u"][:, : want["k"]])
    from_base = post.rsample_from_base_samples(u).numpy()
    draws = post.rsample((SAMPLES,), base_samples=_base_draw).numpy()
    for got, ref in ((from_base, want["from_base"]), (draws, want["draws"])):
        assert got.shape == (SAMPLES, M)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def test_sample_root_approximates_the_love_covariance(injected):
    # a full-rank root (40 Ritz pairs of a 40-point posterior) reproduces the LOVE
    # predictive covariance up to the Ritz floor
    post = _torch_posterior(False)
    train_x, train_y, test_x = _task(N, M)
    tm = TorchModel(torch.from_numpy(train_x), torch.from_numpy(train_y), gt.likelihoods.GaussianLikelihood()).double()
    gt.load_jax_params(tm, PARAMS).eval()
    with gt.settings.fast_pred_var(True), torch.no_grad():
        love = tm(torch.from_numpy(test_x)).covariance_matrix
    torch.testing.assert_close(post.covariance_matrix, love, rtol=0, atol=1e-6 * love.abs().max().item())


def test_samples_from_a_generator_are_gaussian_and_reproducible():
    post = _torch_posterior(False)
    draw = post.sample((4000,), base_samples=torch.Generator().manual_seed(5))
    again = post.rsample((4000,), base_samples=torch.Generator().manual_seed(5))
    torch.testing.assert_close(draw, again, rtol=0, atol=0)
    assert not again.requires_grad and torch.isfinite(draw).all()
    # base samples are standard normal (never Rademacher ±1): the draws' sample covariance
    # matches R_s R_sᵀ within the sampling error of 4,000 draws
    base = post.get_base_samples((4000,), base_samples=torch.Generator().manual_seed(5))
    assert base.shape == (4000, post.lazy_covariance_matrix.root.shape[-1])
    assert (base.abs() != 1.0).all()
    centred = draw - post.mean
    cov, want = centred.mT @ centred / 4000, post.covariance_matrix
    assert (cov - want).abs().max().item() < 0.1 * want.diagonal().max().item()
    torch.testing.assert_close(post.rsample_from_base_samples(base), draw, rtol=1e-12, atol=1e-12)


def test_dense_covariance_samples_through_its_cholesky_root():
    # a plain MultivariateNormal of 50 points: its root is the (jittered) Cholesky factor,
    # as in the JAX package; rsample draws its base samples (n_samples, k, 1) through
    # probe_base_samples
    rng = np.random.default_rng(1)
    a = rng.normal(size=(50, 50))
    mean, cov = rng.normal(size=50), a @ a.T / 50 + 0.1 * np.eye(50)
    u = _base_draw((6, 50))
    want = np.asarray(jax.jit(lambda m, c, b: gp.distributions.MultivariateNormal(m, c).rsample_from_base_samples(b))(
        jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(u)))
    dist = gt.distributions.MultivariateNormal(torch.from_numpy(mean), torch.from_numpy(cov))
    np.testing.assert_allclose(dist.rsample_from_base_samples(torch.from_numpy(u)).numpy(), want, rtol=1e-12,
                               atol=1e-12)
    got = dist.rsample((3, 2), base_samples=_base_draw)
    assert got.shape == (3, 2, 50)
    base = torch.from_numpy(_base_draw((6, 50, 1)))[..., 0]
    torch.testing.assert_close(got.reshape(6, 50), dist.rsample_from_base_samples(base), rtol=1e-12, atol=1e-12)


def test_one_draw_launches_seven_products(monkeypatch):
    # What chip_smoke.py gates on the card: with the caches built, one request under
    # fast_pred_samples takes one product for the mean (t=1), one for K*x R (t=100) and
    # one for each of the sample root's 5 Lanczos blocks on K** (t=20, symmetric)
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    calls = []
    plain = fk.fused_kernel_matvec

    def counted(x1, x2, v, kernel_type, symmetric=False, grad_only=False):
        calls.append((v.shape[1], x1 is x2))
        return plain(x1, x2, v, kernel_type, symmetric, grad_only)

    monkeypatch.setattr(fk, "fused_kernel_matvec", counted)
    n, m = 600, 520  # n², n·m and m² > max_eager_kernel_size², so every product streams
    train_x, train_y, test_x = _task(n, m)
    tm = TorchModel(torch.from_numpy(train_x).float(), torch.from_numpy(train_y).float(),
                    gt.likelihoods.GaussianLikelihood())
    gt.load_jax_params(tm, PARAMS).eval()
    with gt.settings.max_cholesky_size(0), gt.settings.fast_pred_samples(True), torch.no_grad():
        tm.refresh()
        calls.clear()
        post = tm(torch.from_numpy(test_x).float())
        draws = post.rsample((SAMPLES,), base_samples=torch.Generator().manual_seed(0))
    assert calls == [(1, False), (100, False)] + [(20, True)] * 5
    assert draws.shape == (SAMPLES, m) and torch.isfinite(draws).all()


def test_root_operator_add_low_rank_and_its_own_root():
    # RootLinearOperator is its own root decomposition, and add_low_rank appends columns:
    # [R | S] [R | S]ᵀ = R Rᵀ + S Sᵀ, the JAX package's RootLinearOperator.add_low_rank
    rng = np.random.default_rng(4)
    R, S = rng.normal(size=(30, 5)), rng.normal(size=(30, 2))
    want = np.asarray(gp.linop.RootLinearOperator(jnp.asarray(R)).add_low_rank(jnp.asarray(S)).to_dense())
    root = gt.linop.RootLinearOperator(torch.from_numpy(R))
    assert root.root_decomposition() is root
    for new in (torch.from_numpy(S), gt.linop.DenseLinearOperator(torch.from_numpy(S))):
        got = root.add_low_rank(new)
        assert got.root.shape == (30, 7)
        np.testing.assert_allclose(got.to_dense().numpy(), want, rtol=1e-12, atol=1e-12)
