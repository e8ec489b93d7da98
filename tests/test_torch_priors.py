"""The port's priors (gpytorch_tpu_torch/priors), their registration on modules, and the
exact MLL of bench.py's honest recipe against the JAX package, in float64 on the CPU.

The honest recipe (bench.py, BENCH_HONEST=1): GaussianLikelihood with a LogNormal(−4, 1)
noise prior and a GreaterThan(1e-4) noise floor, CG at tolerance 0.05 with a stall window
of 50.  The same numpy data, raw parameters and (on mBCG) probe base samples go through
both packages.  The JAX package counts the likelihood's priors twice in the exact MLL (its
model's prior sum already holds them, and it adds the likelihood's again); the port
counts each prior once, so it equals the JAX value minus one copy of the likelihood's
prior term, divided by N.

Tolerances: priors' log-densities 1e-12 relative (the same closed forms); the MLL 1e-9 on
the Cholesky branch (distances in float64 in both, ``_exact_float64_sq_dist``) and 1e-8 on
mBCG (CG, eigh and Cholesky in another order, as in test_torch_exact_training.py).
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
import gpytorch_tpu_torch as gt
from gpytorch_tpu.models import ExactGP as JaxExactGP

N, D, PROBES = 300, 3, 8
NOISE_FLOOR = 1e-4
PARAMS = {
    "covar_module.base_kernel.raw_lengthscale": np.array([[-0.4, 0.1, -0.7]]),
    "covar_module.raw_outputscale": np.array(0.5),
    "likelihood.noise_covar.raw_noise": np.array([-3.0]),
    "mean_module.raw_constant": np.array(0.05),
}
# hyperparameters as float64 numpy scalars, so that both packages hold the same values
PRIORS = [
    ("NormalPrior", (0.3, 1.5), np.array([-1.2, 0.03, 0.5, 1.9])),
    ("HalfNormalPrior", (0.7,), np.array([0.03, 0.5, 1.2, 1.9])),
    ("LogNormalPrior", (-4.0, 1.0), np.array([1e-4, 0.018, 0.5, 1.9])),
    ("UniformPrior", (0.1, 2.0), np.array([0.11, 0.5, 1.2, 1.9])),
    ("HalfCauchyPrior", (0.4,), np.array([0.03, 0.5, 1.2, 19.0])),
    ("GammaPrior", (3.0, 6.0), np.array([0.03, 0.5, 1.2, 1.9])),
    ("GammaPrior", (0.5, 2.0), np.array([0.03, 0.5, 1.2, 1.9])),
]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _f64(args):
    return tuple(np.float64(a) for a in args)


@pytest.mark.parametrize("name,args,x", PRIORS, ids=[f"{p[0]}{p[1]}" for p in PRIORS])
def test_prior_log_prob_matches_jax_package(name, args, x):
    want = np.asarray(getattr(gp.priors, name)(*args).log_prob(jnp.asarray(x)))
    got = getattr(gt.priors, name)(*_f64(args)).log_prob(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("name,args", [("HalfNormalPrior", (0.7,)), ("HalfCauchyPrior", (0.4,)),
                                       ("UniformPrior", (0.1, 2.0))])
def test_prior_log_prob_outside_the_support_matches_jax_package(name, args):
    x = np.array([-0.5, 2.5, -3.0])
    want = np.asarray(getattr(gp.priors, name)(*args).log_prob(jnp.asarray(x)))
    got = getattr(gt.priors, name)(*_f64(args)).log_prob(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(want)], want[~np.isinf(want)], rtol=1e-12)


def test_multivariate_normal_prior_log_prob_matches_jax_package():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 3))
    mean, cov, x = rng.normal(size=3), a @ a.T + np.eye(3), rng.normal(size=(5, 3))
    want = np.asarray(gp.priors.MultivariateNormalPrior(jnp.asarray(mean), jnp.asarray(cov)).log_prob(jnp.asarray(x)))
    got = gt.priors.MultivariateNormalPrior(mean, cov).log_prob(torch.from_numpy(x)).numpy()
    # the JAX package's MultivariateNormal factors cov + 1e-8 I (psd_safe_cholesky always
    # adds its float64 base jitter); torch.distributions factors cov itself
    np.testing.assert_allclose(got, want, rtol=1e-8)
    jittered = gt.priors.MultivariateNormalPrior(mean, cov + 1e-8 * np.eye(3)).log_prob(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(jittered, want, rtol=1e-12)


def test_prior_hyperparameters_are_buffers():
    # an optimiser over the parameters must not train them, and the parameter names must
    # stay the JAX package's (whose trainable_params() leaves them out too)
    jlik = gp.likelihoods.GaussianLikelihood(noise_prior=gp.priors.LogNormalPrior(-4.0, 1.0))
    tlik = gt.likelihoods.GaussianLikelihood(noise_prior=gt.priors.LogNormalPrior(-4.0, 1.0))
    assert [k for k, _ in tlik.named_parameters()] == list(jlik.trainable_params()) == ["noise_covar.raw_noise"]
    assert sorted(k for k, _ in tlik.named_buffers()) == ["noise_covar.noise_prior.loc", "noise_covar.noise_prior.scale"]
    assert sorted(tlik.state_dict()) == ["noise_covar.noise_prior.loc", "noise_covar.noise_prior.scale",
                                         "noise_covar.raw_noise"]
    # the distribution is built from the buffers at each call: it follows .to()
    tlik = tlik.to(torch.float64)
    assert tlik.noise_covar.noise_prior.loc.dtype == torch.float64
    assert tlik.prior_log_prob_sum().dtype == torch.float64


def _models():
    """Each package's flagship model with a prior on every hyperparameter that has one in
    the port: the honest recipe's noise prior, and lengthscale, outputscale and constant
    priors."""

    class JaxModel(JaxExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gp.means.ConstantMean(constant_prior=gp.priors.NormalPrior(0.0, 1.0))
            self.covar_module = gp.kernels.ScaleKernel(
                gp.kernels.RBFKernel(ard_num_dims=D, lengthscale_prior=gp.priors.GammaPrior(3.0, 6.0)),
                outputscale_prior=gp.priors.GammaPrior(2.0, 0.15))

        def forward(self, x):
            return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    class TorchModel(gt.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gt.means.ConstantMean(constant_prior=gt.priors.NormalPrior(0.0, 1.0))
            self.covar_module = gt.kernels.ScaleKernel(
                gt.kernels.RBFKernel(ard_num_dims=D, lengthscale_prior=gt.priors.GammaPrior(3.0, 6.0)),
                outputscale_prior=gt.priors.GammaPrior(2.0, np.float64(0.15)))

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    return JaxModel, TorchModel


def _task(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * np.sin(7 * x[:, 2] * x[:, 0]) + 0.1 * rng.normal(size=n)
    return x, (y - y.mean()) / y.std()


def _exact_float64_sq_dist(x1, x2, x1_eq_x2=False):
    # gpytorch_tpu's sq_dist forms its distance product in float32 even under x64
    adj = jnp.mean(x1, axis=-2, keepdims=True)
    x1, x2 = x1 - adj, x2 - adj
    res = (-2.0 * jnp.matmul(x1, jnp.swapaxes(x2, -1, -2), precision=jax.lax.Precision.HIGHEST)
           + jnp.sum(x1 * x1, -1, keepdims=True) + jnp.swapaxes(jnp.sum(x2 * x2, -1, keepdims=True), -1, -2))
    if x1_eq_x2:
        res = res * (1.0 - jnp.eye(res.shape[-1], dtype=res.dtype))
    return jnp.maximum(res, 0.0)


def _probe_draw(shape):
    return np.random.default_rng([5, *shape]).normal(size=shape)


# the probe base samples of the rank-50 preconditioner: (t, k, 1) and (t, n)
PROBE_SHAPES = ((PROBES, 50, 1), (PROBES, N))
_JAX_DRAWS = {}


def _honest_settings(mod, mbcg):
    """bench.py's honest CG settings; with ``mbcg`` the iterative branch (8 probes, the
    rank-50 preconditioner), else the default settings (dense Cholesky at N=300)."""
    stack = contextlib.ExitStack()
    stack.enter_context(mod.cg_tolerance(0.05))
    stack.enter_context(mod.cg_stall_window(50))
    if mbcg:
        for ctx in (mod.max_cholesky_size(0), mod.min_preconditioning_size(0), mod.max_cg_iterations(100),
                    mod.num_trace_samples(PROBES), mod.max_lanczos_quadrature_iterations(5),
                    mod.max_preconditioner_size(50), mod.preconditioner_noise_budget(1e-3)):
            stack.enter_context(ctx)
    return stack


@functools.lru_cache(maxsize=None)
def _jax_mll(mbcg, priors):
    """jit(value_and_grad) of the JAX package's MLL over the raw parameters, with the
    noise prior (``priors``) or without; and of its likelihood's prior term / N."""
    x, y = (jnp.asarray(a) for a in _task(N))
    JaxModel, _ = _models()
    noise_prior = gp.priors.LogNormalPrior(-4.0, 1.0) if priors else None
    jm = JaxModel(x, y, gp.likelihoods.GaussianLikelihood(noise_prior=noise_prior,
                                                           noise_constraint=gp.constraints.GreaterThan(NOISE_FLOOR)))

    def mll(p, draws):
        _JAX_DRAWS["draws"] = draws
        m = jm.with_params(p)
        with _honest_settings(gp.settings, mbcg):
            return gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(x), y, key=jax.random.PRNGKey(0))

    def lik_prior(p):
        return jm.with_params(p).likelihood.prior_log_prob_sum() / N

    return jax.jit(jax.value_and_grad(mll)), jax.jit(jax.value_and_grad(lik_prior)) if priors else None


def _torch_mll(mbcg):
    x, y = _task(N)
    _, TorchModel = _models()
    lik = gt.likelihoods.GaussianLikelihood(noise_prior=gt.priors.LogNormalPrior(-4.0, 1.0),
                                            noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR))
    tm = gt.load_jax_params(TorchModel(torch.from_numpy(x), torch.from_numpy(y), lik).double(), PARAMS)
    with _honest_settings(gt.settings, mbcg):
        value = gt.mlls.ExactMarginalLogLikelihood(tm.likelihood, tm)(tm(tm.train_inputs[0]), tm.train_targets,
                                                                       base_samples=_probe_draw)
    value.backward()
    return value.item(), {k: p.grad.numpy() for k, p in tm.named_parameters()}


@pytest.fixture
def jax_side(monkeypatch):
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    monkeypatch.setattr(gpytorch_tpu.linop.root, "probe_base_samples",
                        lambda key, shape, dtype: _JAX_DRAWS["draws"][tuple(shape)].astype(dtype))


@pytest.mark.parametrize("mbcg,rtol", [(False, 1e-9), (True, 1e-8)], ids=["cholesky", "mbcg"])
def test_honest_mll_counts_each_prior_once(jax_side, mbcg, rtol):
    params = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    draws = {shape: jnp.asarray(_probe_draw(shape)) for shape in PROBE_SHAPES}
    mll_vg, prior_vg = _jax_mll(mbcg, True)
    (jval, jgrad), (jprior, jprior_grad) = mll_vg(params, draws), prior_vg(params)
    tval, tgrad = _torch_mll(mbcg)
    # the port = the JAX package's value less one copy of the likelihood's prior term
    np.testing.assert_allclose(tval, float(jval) - float(jprior), rtol=rtol)
    assert set(tgrad) == set(jgrad)
    for name, g in tgrad.items():
        want = np.asarray(jgrad[name]) - np.asarray(jprior_grad[name])
        np.testing.assert_allclose(g, want, rtol=rtol, atol=rtol * np.abs(want).max(), err_msg=name)
    # and the JAX package counts the noise prior twice: with it, its MLL rises by two copies
    jval_none = _jax_mll(mbcg, False)[0](params, draws)[0]
    np.testing.assert_allclose(float(jval) - float(jval_none), 2.0 * float(jprior), rtol=1e-6)
    assert abs(float(jprior)) > 1e-3  # large enough to tell one copy from two


def test_named_priors_visits_a_shared_likelihood_once():
    x, y = _task(20)
    _, TorchModel = _models()
    lik = gt.likelihoods.GaussianLikelihood(noise_prior=gt.priors.LogNormalPrior(-4.0, 1.0))
    tm = TorchModel(torch.from_numpy(x), torch.from_numpy(y), lik)
    mll = gt.mlls.ExactMarginalLogLikelihood(lik, tm)
    names = sorted(name for name, *_ in mll.named_priors())
    # the likelihood is the MLL's child and the model's: visited once, under its first name
    assert names == ["likelihood.noise_covar.noise_prior", "model.covar_module.base_kernel.lengthscale_prior",
                     "model.covar_module.outputscale_prior", "model.mean_module.mean_prior"]
    total = sum(prior.log_prob(closure(module)).sum() for _, module, prior, closure, _ in mll.named_priors())
    torch.testing.assert_close(mll.prior_log_prob_sum(), total)


def test_sample_from_prior_writes_the_draw_back():
    x, y = _task(20)
    _, TorchModel = _models()
    lik = gt.likelihoods.GaussianLikelihood(noise_prior=gt.priors.LogNormalPrior(-4.0, 1.0))
    tm = TorchModel(torch.from_numpy(x), torch.from_numpy(y), lik).double()
    cases = [(tm.likelihood.noise_covar, "noise_prior", lambda: tm.likelihood.noise),
             (tm.covar_module.base_kernel, "lengthscale_prior", lambda: tm.covar_module.base_kernel.lengthscale),
             (tm.covar_module, "outputscale_prior", lambda: tm.covar_module.outputscale),
             (tm.mean_module, "mean_prior", lambda: tm.mean_module.constant)]
    for module, name, read in cases:
        module.sample_from_prior(name, generator=torch.Generator().manual_seed(7))
        draw = getattr(module, name).sample(generator=torch.Generator().manual_seed(7))
        torch.testing.assert_close(read().detach(), draw.expand_as(read()), rtol=1e-12, atol=1e-15)
    with pytest.raises(RuntimeError, match="Unknown prior"):
        tm.mean_module.sample_from_prior("noise_prior")


SAMPLED = [("NormalPrior", (0.3, 1.5)), ("HalfNormalPrior", (0.7,)), ("LogNormalPrior", (-4.0, 1.0)),
           ("UniformPrior", (0.1, 2.0)), ("HalfCauchyPrior", (0.4,)), ("GammaPrior", (3.0, 6.0)),
           ("GammaPrior", (0.5, 2.0))]


@pytest.mark.parametrize("name,args", SAMPLED, ids=[f"{p[0]}{p[1]}" for p in SAMPLED])
def test_prior_samples_follow_the_distribution(name, args):
    # 20,000 draws from a seeded generator: the empirical CDF within 0.015 of the
    # distribution's at its deciles (the Kolmogorov–Smirnov statistic's 1 % point is 0.0115)
    prior = getattr(gt.priors, name)(*_f64(args))
    draws = prior.sample((20_000,), generator=torch.Generator().manual_seed(0))
    again = prior.sample((20_000,), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(draws, again, rtol=0, atol=0)
    dist = prior.distribution()
    cdf = dist.cdf if name != "HalfCauchyPrior" else (lambda v: 2.0 / np.pi * torch.atan(v / prior.scale))
    sorted_draws = draws.sort().values
    points = sorted_draws[torch.arange(1, 10) * 2000]
    gap = (cdf(points) - torch.arange(1, 10, dtype=torch.float64) * 0.1).abs().max().item()
    assert gap < 0.015, gap
    assert bool((prior.log_prob(draws) > -np.inf).all())


def test_multivariate_normal_prior_samples_follow_the_distribution():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 3))
    mean, cov = rng.normal(size=3), a @ a.T + np.eye(3)
    draws = gt.priors.MultivariateNormalPrior(mean, cov).sample((40_000,), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(draws.mean(0).numpy(), mean, atol=0.05)
    np.testing.assert_allclose(np.cov(draws.numpy().T), cov, rtol=0.05, atol=0.05)


def test_load_jax_params_carries_a_model_with_priors():
    x, y = _task(50)
    JaxModel, TorchModel = _models()
    jm = JaxModel(jnp.asarray(x), jnp.asarray(y), gp.likelihoods.GaussianLikelihood(
        noise_prior=gp.priors.LogNormalPrior(-4.0, 1.0), noise_constraint=gp.constraints.GreaterThan(NOISE_FLOOR)))
    jm = jm.with_params({k: jnp.asarray(v) for k, v in PARAMS.items()})
    params = {k: np.asarray(v) for k, v in jm.trainable_params().items()}
    assert set(params) == set(PARAMS)  # the priors' hyperparameters are not parameters there either
    tm = TorchModel(torch.from_numpy(x), torch.from_numpy(y), gt.likelihoods.GaussianLikelihood(
        noise_prior=gt.priors.LogNormalPrior(-4.0, 1.0), noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR)))
    tm = gt.load_jax_params(tm.double(), params)
    # the likelihood's prior term and the model's (which holds the likelihood) agree
    np.testing.assert_allclose(tm.likelihood.prior_log_prob_sum().item(), float(jm.likelihood.prior_log_prob_sum()),
                               rtol=1e-12)
    np.testing.assert_allclose(tm.prior_log_prob_sum().item(), float(jm.prior_log_prob_sum()), rtol=1e-12)
    # and the model round-trips through its own state dict, buffers included
    clone = TorchModel(torch.from_numpy(x), torch.from_numpy(y), gt.likelihoods.GaussianLikelihood(
        noise_prior=gt.priors.LogNormalPrior(0.0, 2.0), noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR)))
    clone.double().load_state_dict(tm.state_dict())
    np.testing.assert_allclose(clone.prior_log_prob_sum().item(), tm.prior_log_prob_sum().item(), rtol=1e-15)
