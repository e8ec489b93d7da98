"""The port's non-Gaussian likelihoods against the JAX package, in float64 on the CPU.

Each of Bernoulli (probit), Beta, Laplace, Student-t, Poisson and negative binomial at raw
parameters away from their initial values (carried with ``load_jax_params``), on a q(f) of
30 points with a diagonal covariance: ``expected_log_prob`` and ``log_marginal`` (both by
20-node Gauss–Hermite quadrature, Bernoulli's log marginal in closed form) and ``marginal``
(Bernoulli's closed form; the others a Monte Carlo mixture, compared as p(y | f) at the
same draws f = μ + σε, ε injected into the port as ``base_samples``).  The softmax
likelihood's ``forward`` with and without mixing weights, and its Monte Carlo
``expected_log_prob`` at the same draws.  Also the quadrature itself against a closed form.

Tolerance: 1e-12 relative (the same float64 formulas; ``torch.distributions`` and the JAX
package's distributions differ only in how they arrange the log-gamma terms).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt

RTOL = 1e-12
N, S = 30, 10
F64 = jnp.float64


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _q_f(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=N) * 0.8, rng.uniform(0.05, 0.6, size=N)


def _dists(mean, var):
    jd = gp.distributions.MultivariateNormal(jnp.asarray(mean), gp.linop.DiagLinearOperator(jnp.asarray(var)))
    td = gt.distributions.MultivariateNormal(torch.from_numpy(mean), gt.linop.DiagLinearOperator(torch.from_numpy(var)))
    return jd, td


def _observations(kind, rng):
    if kind == "bernoulli":
        return (rng.uniform(size=N) < 0.5).astype(np.float64)
    if kind == "beta":
        return rng.uniform(0.05, 0.95, size=N)
    if kind in ("poisson", "negative_binomial"):
        return rng.poisson(2.0, size=N).astype(np.float64)
    return rng.normal(size=N)


# (JAX class, port class, raw parameters away from their initial values)
CASES = {
    "bernoulli": ("BernoulliLikelihood", {}),
    "beta": ("BetaLikelihood", {"raw_scale": np.array([1.7])}),
    "laplace": ("LaplaceLikelihood", {"raw_noise": np.array([-0.6])}),
    "student_t": ("StudentTLikelihood", {"raw_deg_free": np.array([2.5]), "raw_noise": np.array([-1.1])}),
    "poisson": ("PoissonLikelihood", {}),
    "negative_binomial": ("NegativeBinomialLikelihood", {"raw_probs": np.array([0.4])}),
}


def _pair(kind):
    name, params = CASES[kind]
    jl = getattr(gp.likelihoods, name)()
    if params:
        jl = jl.with_params({k: jnp.asarray(v) for k, v in params.items()})
    tl = getattr(gt.likelihoods, name)().double()
    if params:
        gt.load_jax_params(tl, params)
    return jl, tl


@pytest.mark.parametrize("kind", list(CASES))
def test_expectations_match_jax(kind):
    # E_q[log p(y | f)] and log E_q[p(y | f)] pointwise at 30 points, 1e-12 relative
    mean, var = _q_f()
    y = _observations(kind, np.random.default_rng(1))
    jl, tl = _pair(kind)
    jd, td = _dists(mean, var)
    j_elp = jax.jit(lambda yy: jl.expected_log_prob(yy, jd))(jnp.asarray(y))
    j_lm = jax.jit(lambda yy: jl.log_marginal(yy, jd))(jnp.asarray(y))
    np.testing.assert_allclose(tl.expected_log_prob(torch.from_numpy(y), td).detach().numpy(), np.asarray(j_elp),
                               rtol=RTOL)
    np.testing.assert_allclose(tl.log_marginal(torch.from_numpy(y), td).detach().numpy(), np.asarray(j_lm), rtol=RTOL)


@pytest.mark.parametrize("kind", list(CASES))
def test_marginal_matches_jax(kind):
    # Bernoulli: the closed-form marginal's probabilities; the others: p(y | f) of the
    # marginal's mixture at the injected draws f = μ + σε against the JAX likelihood's
    # forward at the same draws (log-probabilities and means), 1e-12 relative
    mean, var = _q_f(2)
    y = _observations(kind, np.random.default_rng(3))
    jl, tl = _pair(kind)
    jd, td = _dists(mean, var)
    if kind == "bernoulli":
        np.testing.assert_allclose(tl.marginal(td).probs.numpy(), np.asarray(jl.marginal(jd).probs), rtol=RTOL)
        return
    eps = np.random.default_rng(4).normal(size=(S, N))
    got = tl.marginal(td, base_samples=lambda shape: eps.reshape(shape))
    want = jl.forward(jnp.asarray(mean + np.sqrt(var) * eps))
    np.testing.assert_allclose(got.log_prob(torch.from_numpy(y)).detach().numpy(), np.asarray(want.log_prob(y)),
                               rtol=RTOL)
    np.testing.assert_allclose(got.mean.detach().numpy(), np.asarray(want.mean), rtol=RTOL)


def test_bernoulli_closed_forms_against_quadrature():
    # the probit's log marginal log Φ(±μ/√(1 + σ²)) against 60-node quadrature of Φ(±f),
    # 1e-10 relative
    mean, var = _q_f(5)
    _, td = _dists(mean, var)
    lik = gt.likelihoods.BernoulliLikelihood().double()
    y = torch.from_numpy((np.arange(N) % 2).astype(np.float64))
    quad = gt.utils.quadrature.GaussHermiteQuadrature1D(60).double()
    by_quadrature = quad(lambda f: torch.special.ndtr(f * (2 * y - 1)), td).log()
    np.testing.assert_allclose(lik.log_marginal(y, td).numpy(), by_quadrature.numpy(), rtol=1e-10)


def test_quadrature_matches_jax_and_moments():
    # E[f²] and E[exp f] of N(μ, σ²) by the default 20 nodes: the JAX package's at 1e-12, and
    # the closed forms μ² + σ² (exact for a polynomial) and exp(μ + σ²/2) at 1e-12
    mean, var = _q_f(6)
    jd, td = _dists(mean, var)
    jq, tq = gp.utils.quadrature.GaussHermiteQuadrature1D(), gt.utils.quadrature.GaussHermiteQuadrature1D().double()
    for fn_j, fn_t, exact in ((lambda f: f ** 2, lambda f: f ** 2, mean ** 2 + var),
                              (jnp.exp, torch.exp, np.exp(mean + var / 2))):
        got = tq(fn_t, td).numpy()
        np.testing.assert_allclose(got, np.asarray(jq(fn_j, jd)), rtol=RTOL)
        np.testing.assert_allclose(got, exact, rtol=RTOL)


@pytest.mark.parametrize("mixing", [True, False])
def test_softmax_matches_jax(mixing):
    # forward on (num_features, n) draws: the categorical's log-probabilities of labels, 1e-12;
    # the Monte Carlo expected log likelihood over 10 injected draws of 4 independent latent
    # functions (a batch of MultivariateNormals), 1e-12
    C, F = 3, 4
    rng = np.random.default_rng(7)
    W = rng.normal(size=(C, F))
    jl = gp.likelihoods.SoftmaxLikelihood(num_features=F, num_classes=C, mixing_weights=mixing, dtype=F64)
    tl = gt.likelihoods.SoftmaxLikelihood(num_features=F, num_classes=C, mixing_weights=mixing).double()
    if mixing:
        jl = jl.with_params({"mixing_weights": jnp.asarray(W)})
        gt.load_jax_params(tl, {"mixing_weights": W})
    features = F if mixing else C
    f = rng.normal(size=(S, features, N))
    labels = rng.integers(0, C, size=N).astype(np.float64)
    # the JAX package's categorical takes labels of its batch's shape
    jlabels = jnp.broadcast_to(jnp.asarray(labels), (S, N))
    np.testing.assert_allclose(tl(torch.from_numpy(f)).log_prob(torch.from_numpy(labels)).detach().numpy(),
                               np.asarray(jl(jnp.asarray(f)).log_prob(jlabels)), rtol=RTOL)
    mean, var = rng.normal(size=(features, N)), rng.uniform(0.1, 0.5, size=(features, N))
    eps = rng.normal(size=(S, features, N))
    td = gt.distributions.MultivariateNormal(torch.from_numpy(mean), gt.linop.DiagLinearOperator(torch.from_numpy(var)))
    got = tl.expected_log_prob(torch.from_numpy(labels), td, base_samples=lambda shape: eps.reshape(shape))
    want = np.asarray(jl.forward(jnp.asarray(mean + np.sqrt(var) * eps)).log_prob(jlabels)).mean(0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL)


def test_parameters_constraints_and_gradients():
    # the constrained values behind each raw parameter, load_jax_params's carry of every new
    # likelihood's raw parameters, and a finite gradient of each expected log likelihood
    mean, var = _q_f(8)
    for kind, (name, params) in CASES.items():
        jl, tl = _pair(kind)
        for raw in params:
            attr = raw[len("raw_"):]
            np.testing.assert_allclose(getattr(tl, attr).detach().numpy(), np.asarray(getattr(jl, attr)), rtol=RTOL)
        tm = torch.from_numpy(mean).requires_grad_()
        td = gt.distributions.MultivariateNormal(tm, gt.linop.DiagLinearOperator(torch.from_numpy(var)))
        tl.expected_log_prob(torch.from_numpy(_observations(kind, np.random.default_rng(9))), td).sum().backward()
        assert torch.isfinite(tm.grad).all(), kind
    assert gt.likelihoods.StudentTLikelihood().deg_free.item() == pytest.approx(7.0)
    with pytest.raises(ValueError):
        gt.likelihoods.NegativeBinomialLikelihood().initialize(probs=1.5)


# -- deep sigma point processes -----------------------------------------------------------------

DQ, DM, DH, DN = 5, 8, 2, 30  # quadrature sites, inducing points per layer, hidden outputs, points


def _exact_float64_sq_dist(x1, x2, x1_eq_x2=False):
    adj = jnp.mean(x1, axis=-2, keepdims=True)
    x1, x2 = x1 - adj, x2 - adj
    res = (-2.0 * jnp.matmul(x1, jnp.swapaxes(x2, -1, -2), precision=jax.lax.Precision.HIGHEST)
           + jnp.sum(x1 * x1, -1, keepdims=True) + jnp.swapaxes(jnp.sum(x2 * x2, -1, keepdims=True), -1, -2))
    if x1_eq_x2:
        res = res * (1.0 - jnp.eye(res.shape[-1], dtype=res.dtype))
    return jnp.maximum(res, 0.0)


def _dspp(pkg):
    kw = {"dtype": F64} if pkg is gp else {}

    class Layer(pkg.models.deep_gps.DSPPLayer):
        def __init__(self, input_dims, output_dims):
            batch = () if output_dims is None else (output_dims,)
            vd = pkg.variational.CholeskyVariationalDistribution(DM, batch_shape=batch, **kw)
            Z = np.zeros(batch + (DM, input_dims))  # replaced by the loaded parameters
            Z = jnp.asarray(Z) if pkg is gp else torch.from_numpy(Z)
            super().__init__(pkg.variational.VariationalStrategy(self, Z, vd), input_dims, output_dims,
                             num_quad_sites=DQ)
            self.mean_module = pkg.means.ConstantMean(batch_shape=batch, **kw)
            self.covar_module = pkg.kernels.ScaleKernel(
                pkg.kernels.RBFKernel(ard_num_dims=input_dims, batch_shape=batch, **kw), batch_shape=batch, **kw)

        def forward(self, x):
            return pkg.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    class TwoLayerDSPP(pkg.models.deep_gps.DSPP):
        def __init__(self):
            super().__init__(num_quad_sites=DQ)
            self.hidden_layer = Layer(3, DH)
            self.last_layer = Layer(DH, None)
            self.likelihood = pkg.likelihoods.GaussianLikelihood(**kw)

        def forward(self, x):
            return self.last_layer(self.hidden_layer(x))

    return TwoLayerDSPP() if pkg is gp else TwoLayerDSPP().double()


def _dspp_value(name, shape, rng):
    if name.endswith("chol_variational_covar"):
        diag = rng.uniform(0.3, 1.0, size=shape[:-1])[..., None, :]
        return np.tril(0.2 * rng.normal(size=shape), -1) + np.eye(shape[-1]) * diag
    if name.endswith("inducing_points"):
        return rng.uniform(size=shape) if "hidden" in name else rng.normal(size=shape)
    if name.endswith("raw_noise"):
        return np.full(shape, -2.0)
    if name.endswith("quad_sites"):
        return np.polynomial.hermite_e.hermegauss(DQ)[0] + 0.1 * rng.normal(size=shape)
    if name.endswith("raw_lengthscale"):
        return rng.uniform(-0.6, 0.4, size=shape)
    return 0.5 * rng.normal(size=shape)


def test_dspp_predictive_log_likelihood_matches_jax(monkeypatch):
    # a two-layer DSPP (2 hidden GPs, 8 inducing points a layer, 5 quadrature sites, learned
    # sites and quadrature weights): DeepPredictiveLogLikelihood's value on 30 points and its
    # gradient with respect to every parameter (load_jax_params carries quad_sites and
    # raw_quad_weights) against jax.value_and_grad, 1e-8 relative; the output's site dimension
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    rng = np.random.default_rng(11)
    x = rng.uniform(size=(DN, 3))
    y = np.sin(4 * x[:, 0]) + 0.3 * x[:, 1] + 0.1 * rng.normal(size=DN)
    jm = _dspp(gp)
    jm(jnp.asarray(x[:4]))  # eager initialisation, then overwritten
    params = {k: _dspp_value(k, np.shape(v), rng) for k, v in sorted(jm.trainable_params().items())}
    assert {"raw_quad_weights", "hidden_layer.quad_sites", "last_layer.quad_sites"} <= set(params)
    jm = jm.with_params({k: jnp.asarray(v) for k, v in params.items()})
    tm = _dspp(gt)
    gt.load_jax_params(tm, {**params, **{f"{layer}.variational_strategy.variational_params_initialized": 1
                                          for layer in ("hidden_layer", "last_layer")}})

    def jax_loss(p):
        m = jm.with_params(p)
        return gp.mlls.DeepPredictiveLogLikelihood(m.likelihood, m, num_data=100)(m(jnp.asarray(x)), jnp.asarray(y))

    jval, jgrad = jax.jit(jax.value_and_grad(jax_loss))({k: jnp.asarray(v) for k, v in params.items()})
    out = tm(torch.from_numpy(x))
    assert out.mean.shape == (DQ, DN)
    loss = gt.mlls.DeepPredictiveLogLikelihood(tm.likelihood, tm, num_data=100)(out, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-8)
    np.testing.assert_allclose(tm.quad_weights.exp().sum().item(), 1.0, rtol=1e-12)
    own = dict(tm.named_parameters())
    for name, g in jgrad.items():
        g = np.asarray(g)
        t_grad = own[name].grad  # None for the first layer's sites, which its deterministic inputs never read
        np.testing.assert_allclose(np.zeros_like(g) if t_grad is None else t_grad.numpy(), g, rtol=1e-8,
                                   atol=1e-8 * max(np.abs(g).max(), 1e-30),
                                   err_msg=name)
