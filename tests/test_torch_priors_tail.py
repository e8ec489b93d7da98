"""The port's LKJ, Wishart, horseshoe and smoothed-box priors and ``priors/utils.py`` against
the JAX package, in float64 on the CPU, and their samplers.

Where the JAX package departs from the density it names, the port computes the density and a
second assertion pins the JAX value:
* ``LKJCholeskyFactorPrior``: the port equals ``torch.distributions.LKJCholesky``; the JAX
  package's exponent is one higher, so its value is the port's + Σᵢ log L_ii;
* ``HorseshoePrior``: the port lies inside Carvalho, Polson and Scott's (2010) bounds and
  within half their gap of the density by quadrature; the JAX value has the bounds' logs
  swapped and another constant, and falls below the lower bound;
* the LKJ sampler: the port's draws have E[r_ij²] = 1/(2η + n − 1); the JAX package's
  correlation of A Aᵀ (A of n × (n + 2)) is LKJ(1.5) whatever η is.

Tolerance: 1e-12 relative for closed forms (the same formulas); moments within 5 standard
errors of the mean of 40,000 draws from a seeded generator.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import integrate, stats

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt
from gpytorch_tpu_torch.priors import utils as prior_utils

RTOL = 1e-12
DRAWS = 40_000
LKJ_CASES = [(2, 1.0), (3, 2.0), (4, 0.7)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _correlation_factors(n, count, seed):
    """Cholesky factors of random correlation matrices (rows of a lower-triangular Gaussian
    matrix normalised)."""
    rng = np.random.default_rng(seed)
    L = np.tril(rng.normal(size=(count, n, n)))
    L[:, np.arange(n), np.arange(n)] = np.abs(L[:, np.arange(n), np.arange(n)]) + 0.3
    return L / np.linalg.norm(L, axis=-1, keepdims=True)


def _spd(p, count, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(count, p, p + 2))
    return A @ np.swapaxes(A, -1, -2) / (p + 2) + 0.2 * np.eye(p)


def _within_se(draws, want):
    mean, se = draws.mean(0), draws.std(0) / math.sqrt(draws.shape[0])
    assert bool(((mean - want).abs() <= 5 * se).all()), (mean, want, se)


@pytest.mark.parametrize("x", [np.array([-0.5, 0.1, 0.7, 1.9, 2.05, 2.6]), np.array([[0.2, 3.0], [-1.0, 1.0]])],
                         ids=["1d", "2d"])
def test_smoothed_box_log_prob_matches_jax(x):
    jp = gp.priors.SmoothedBoxPrior(np.float64(0.1), np.float64(2.0), np.float64(0.1))
    tp = gt.priors.SmoothedBoxPrior(np.float64(2.0), np.float64(0.1), np.float64(0.1))  # bounds in either order
    np.testing.assert_allclose(tp.log_prob(torch.from_numpy(x)).numpy(), np.asarray(jp.log_prob(jnp.asarray(x))),
                               rtol=RTOL)
    # it integrates to one: flat inside, Gaussian tails outside
    mass = integrate.quad(lambda v: math.exp(tp.log_prob(torch.tensor(v, dtype=torch.float64)).item()), -2, 4,
                          points=[0.1, 2.0])[0]
    assert abs(mass - 1.0) < 1e-8


@pytest.mark.parametrize("n,eta", LKJ_CASES)
def test_lkj_and_covariance_log_prob_match_jax(n, eta):
    L = _correlation_factors(n, 5, seed=n)
    R = L @ np.swapaxes(L, -1, -2)
    want = np.asarray(gp.priors.LKJPrior(n, np.float64(eta)).log_prob(jnp.asarray(R)))
    got = gt.priors.LKJPrior(n, np.float64(eta)).log_prob(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    sd = np.random.default_rng(7).uniform(0.05, 2.3, size=(5, n))  # inside and outside the box
    S = R * sd[:, :, None] * sd[:, None, :]
    jp = gp.priors.LKJCovariancePrior(n, np.float64(eta), gp.priors.SmoothedBoxPrior(np.float64(0.1), np.float64(2.0),
                                                                                     np.float64(0.1)))
    tp = gt.priors.LKJCovariancePrior(n, np.float64(eta), gt.priors.SmoothedBoxPrior(np.float64(0.1), np.float64(2.0),
                                                                                     np.float64(0.1)))
    np.testing.assert_allclose(tp.log_prob(torch.from_numpy(S)).numpy(), np.asarray(jp.log_prob(jnp.asarray(S))),
                               rtol=RTOL)


@pytest.mark.parametrize("n,eta", LKJ_CASES)
def test_lkj_cholesky_factor_is_torch_lkjcholesky_and_pins_the_jax_exponent(n, eta):
    L = _correlation_factors(n, 6, seed=10 + n)
    got = gt.priors.LKJCholeskyFactorPrior(n, np.float64(eta)).log_prob(torch.from_numpy(L))
    want = torch.distributions.LKJCholesky(n, torch.tensor(eta, dtype=torch.float64)).log_prob(torch.from_numpy(L))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=0)
    jax_value = np.asarray(gp.priors.LKJCholeskyFactorPrior(n, np.float64(eta)).log_prob(jnp.asarray(L)))
    log_diag = np.log(np.diagonal(L, axis1=-2, axis2=-1)).sum(-1)
    np.testing.assert_allclose(jax_value, got.numpy() + log_diag, rtol=RTOL)
    assert np.abs(log_diag).max() > 1e-1  # the two differ
    if n == 2:
        # the density over the one free entry r = L₁₀ (L₁₁ = √(1 − r²)) integrates to one; the
        # JAX package's to B(½, η + ½)/B(½, η) (0.785 at η = 1)
        prior = gt.priors.LKJCholeskyFactorPrior(2, np.float64(eta))

        def density(r):
            factor = torch.tensor([[1.0, 0.0], [r, math.sqrt(1 - r * r)]], dtype=torch.float64)
            return math.exp(prior.log_prob(factor).item())

        assert abs(integrate.quad(density, -1, 1)[0] - 1.0) < 1e-8


def test_lkj_normaliser_matches_torch():
    from gpytorch_tpu_torch.priors.lkj_prior import _lkj_log_norm_const

    for n, eta in LKJ_CASES + [(6, 3.5)]:
        ones = torch.eye(n, dtype=torch.float64)
        torch_const = -torch.distributions.LKJCholesky(n, torch.tensor(eta, dtype=torch.float64)).log_prob(ones)
        torch.testing.assert_close(_lkj_log_norm_const(n, torch.tensor(eta, dtype=torch.float64)), torch_const,
                                   rtol=RTOL, atol=0)


@pytest.mark.parametrize("inverse", [False, True], ids=["wishart", "inverse_wishart"])
def test_wishart_log_prob_matches_jax_and_scipy(inverse):
    K, X = _spd(3, 1, seed=1)[0], _spd(3, 4, seed=2)
    name = "InverseWishartPrior" if inverse else "WishartPrior"
    want = np.asarray(getattr(gp.priors, name)(np.float64(5.5), jnp.asarray(K)).log_prob(jnp.asarray(X)))
    got = getattr(gt.priors, name)(np.float64(5.5), K).log_prob(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # and the density scipy names so (the JAX K is the scale matrix of W and IW alike)
    scipy_dist = stats.invwishart(df=5.5, scale=K) if inverse else stats.wishart(df=5.5, scale=K)
    np.testing.assert_allclose(got, scipy_dist.logpdf(np.moveaxis(X, 0, -1)), rtol=1e-10)


HORSESHOE_THETA = [0.1, 0.5, 1.0, 2.0, 5.0]
_K = 1.0 / math.sqrt(2 * math.pi**3)


def _horseshoe_density(theta):
    """p(θ) with τ = 1 by quadrature: ∫ N(θ; 0, λ²) · 2/(π(1 + λ²)) dλ over λ > 0."""
    f = lambda lam: math.exp(-0.5 * (theta / lam) ** 2) / (math.sqrt(2 * math.pi) * lam) * 2 / (  # noqa: E731
        math.pi * (1 + lam * lam))
    return integrate.quad(f, 0, np.inf, limit=200, epsabs=1e-13)[0]


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_horseshoe_lies_inside_the_bounds_and_pins_the_jax_value(scale):
    x = np.array(HORSESHOE_THETA) * scale
    got = np.exp(gt.priors.HorseshoePrior(np.float64(scale)).log_prob(torch.from_numpy(x)).numpy()) * scale
    theta = np.array(HORSESHOE_THETA)
    lower, upper = _K / 2 * np.log1p(4 / theta**2), _K * np.log1p(2 / theta**2)
    assert np.all((lower < got) & (got < upper))
    true = np.array([_horseshoe_density(t) for t in HORSESHOE_THETA])
    assert np.all(np.abs(got - true) <= (upper - lower) / 2)
    jax_value = np.asarray(gp.priors.HorseshoePrior(np.float64(scale)).log_prob(jnp.asarray(x)))
    pinned = (np.log((0.5 * np.log1p(2 / theta**2) + np.log1p(4 / theta**2)) / 2) - math.log(2 * math.pi**1.5)
              - math.log(scale))
    np.testing.assert_allclose(jax_value, pinned, rtol=RTOL)
    below = np.exp(jax_value) * scale < lower
    assert below[theta >= 1].all(), np.exp(jax_value) * scale


def test_lkj_samples_have_the_lkj_moment():
    for n, eta in LKJ_CASES + [(5, 3.0)]:
        prior = gt.priors.LKJPrior(n, np.float64(eta))
        R = prior.sample((DRAWS,), generator=torch.Generator().manual_seed(n))
        torch.testing.assert_close(R, prior.sample((DRAWS,), generator=torch.Generator().manual_seed(n)), rtol=0, atol=0)
        torch.testing.assert_close(torch.diagonal(R, dim1=-2, dim2=-1), torch.ones(DRAWS, n, dtype=torch.float64))
        assert bool((torch.linalg.eigvalsh(R) > 0).all())
        rows, cols = torch.triu_indices(n, n, 1)
        _within_se(R[:, rows, cols] ** 2, 1.0 / (2 * eta + n - 1))
    # the JAX sampler is LKJ(1.5) at any η: at n = 3, η = 4 its E[r²] reads 1/(2·1.5 + 2), not 1/(2·4 + 2)
    jax_draws = np.asarray(gp.priors.LKJPrior(3, np.float64(4.0)).sample(jax.random.PRNGKey(0), (DRAWS,)))
    jax_r2 = jax_draws[:, 0, 1] ** 2
    assert abs(jax_r2.mean() - 1 / 5) < 5 * jax_r2.std() / math.sqrt(DRAWS)
    assert abs(jax_r2.mean() - 1 / 10) > 0.05


def test_lkj_cholesky_and_covariance_samples():
    n, eta = 4, 2.0
    L = gt.priors.LKJCholeskyFactorPrior(n, np.float64(eta)).sample((DRAWS,), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(L, L.tril())
    assert bool((torch.diagonal(L, dim1=-2, dim2=-1) > 0).all())
    torch.testing.assert_close(L.norm(dim=-1), torch.ones(DRAWS, n, dtype=torch.float64))
    _within_se((L @ L.mT)[:, 3, 1] ** 2, 1.0 / (2 * eta + n - 1))
    box = gt.priors.SmoothedBoxPrior(np.float64(0.1), np.float64(2.0), np.float64(0.1))
    S = gt.priors.LKJCovariancePrior(n, np.float64(eta), box).sample((DRAWS,), generator=torch.Generator().manual_seed(2))
    sd = torch.diagonal(S, dim1=-2, dim2=-1).sqrt()
    assert bool(((sd >= 0.1) & (sd <= 2.0)).all())
    _within_se(sd, torch.full((n,), 1.05, dtype=torch.float64))
    corr = S / (sd.unsqueeze(-1) * sd.unsqueeze(-2))
    _within_se(corr[:, 0, 2] ** 2, 1.0 / (2 * eta + n - 1))


def test_wishart_samples_have_their_means():
    K = torch.from_numpy(_spd(3, 1, seed=4)[0])
    W = gt.priors.WishartPrior(np.float64(6.0), K).sample((DRAWS,), generator=torch.Generator().manual_seed(3))
    _within_se(W, 6.0 * K)
    IW = gt.priors.InverseWishartPrior(np.float64(9.0), K).sample((DRAWS,), generator=torch.Generator().manual_seed(4))
    _within_se(IW, K / (9.0 - 3 - 1))


def test_horseshoe_and_smoothed_box_samples():
    scale = 0.7
    theta = gt.priors.HorseshoePrior(np.float64(scale)).sample((DRAWS,), generator=torch.Generator().manual_seed(5))
    # P(|θ| < τ) = E_λ[2Φ(1/λ) − 1] over λ ~ C⁺(0, 1), by quadrature
    want = integrate.quad(lambda lam: (2 * stats.norm.cdf(1 / lam) - 1) * 2 / (math.pi * (1 + lam * lam)), 0, np.inf)[0]
    inside = (theta.abs() < scale).double()
    _within_se(inside, want)
    _within_se((theta > 0).double(), 0.5)
    box = gt.priors.SmoothedBoxPrior(np.float64(-1.0), np.float64(3.0))
    u = box.sample((DRAWS,), generator=torch.Generator().manual_seed(6))
    assert u.min().item() >= -1.0 and u.max().item() <= 3.0
    _within_se(u, 1.0)


def test_index_kernel_with_an_lkj_covariance_prior_matches_jax():
    # the task-covariance prior of a Hadamard or multitask model: log p(B Bᵀ + diag(v))
    cf, raw_var = np.array([[0.8], [-0.4]]), np.array([-1.0, 0.3])

    def kernel(pkg):
        prior = pkg.priors.LKJCovariancePrior(2, np.float64(1.5), pkg.priors.SmoothedBoxPrior(
            np.float64(0.05), np.float64(3.0), np.float64(0.1)))
        return pkg.kernels.IndexKernel(num_tasks=2, rank=1, prior=prior)

    jk = kernel(gp).with_params({"covar_factor": jnp.asarray(cf), "raw_var": jnp.asarray(raw_var)})
    tk = gt.load_jax_params(kernel(gt).double(), {"covar_factor": cf, "raw_var": raw_var})
    np.testing.assert_allclose(tk.prior_log_prob_sum().item(), float(jk.prior_log_prob_sum()), rtol=RTOL)
    # the prior's hyperparameters are buffers, carried by name
    gt.load_jax_params(tk, {"covar_factor": cf, "raw_var": raw_var, "IndexKernelPrior.correlation_prior.eta": 2.5})
    assert tk.IndexKernelPrior.correlation_prior.eta.item() == 2.5
    with pytest.raises(KeyError, match="unknown"):
        gt.load_jax_params(tk, {"covar_factor": cf, "raw_var": raw_var, "IndexKernelPrior.nu": 2.5})


def test_prior_utils():
    module = gt.priors.NormalPrior(0.0, 1.0)
    module.extra = torch.tensor([1.0, 2.0])
    prior_utils._bufferize_attributes(module, ["extra", "loc"])
    assert "extra" in dict(module.named_buffers()) and "loc" in dict(module.named_buffers())
    module._buffered_tag = torch.tensor(3.0)
    assert prior_utils._load_transformed_to_base_dist(module).tag.item() == 3.0
    prior_utils._del_attributes(module, ["tag", "missing"])
    assert not hasattr(module, "tag")
    with pytest.raises(AttributeError):
        prior_utils._del_attributes(module, ["missing"], raise_on_error=True)
