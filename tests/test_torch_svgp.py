"""The port's sparse variational GPs against the JAX package, in float64 on the CPU.

An SVGP (ConstantMean, ScaleKernel(RBFKernel(ard_num_dims=3)), GaussianLikelihood) on 128
points of a 3-input task with m ≤ 32 inducing points, under the whitened and unwhitened
strategies and each variational distribution.  The same numpy parameters go into both
packages: the JAX model is initialised eagerly, then given the parameters; the port takes
them through ``load_jax_params`` together with the strategy's ``variational_params_initialized``
buffer, so that neither re-initialises q(u) (their initialisation noise comes from different
random streams).  The JAX side gets float64 distances (its ``sq_dist`` forms the distance
product in float32 even under x64) and is ``jax.jit``ted; mBCG probes are injected into both
packages, keyed by their shapes.

Also here: the closed forms of the diagonal, triangular, Cholesky and block operators above
``max_cholesky_size`` (the whitened KL's N(0, I) prior would otherwise go through stochastic
mBCG), the natural-parameter backward against ``jax.vjp``, NGD, the Monte Carlo likelihood
expectations against their closed forms, and ``load_jax_params``'s carry of the initialised
flag.

Tolerances are stated at each test: 1e-8 relative where both packages run the same float64
arithmetic in another order (through a Cholesky factor of K_ZZ + 1e-6·I).
"""

import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu.linop.base
import gpytorch_tpu_torch as gt
import gpytorch_tpu_torch.linop.base
from gpytorch_tpu.variational.natural_variational_distribution import _natural_to_mu_sigma

D, N, M = 3, 128, 16
RTOL = 1e-8
F64 = jnp.float64

DISTS = ["cholesky", "mean_field", "delta", "natural", "tril_natural"]
STRATEGIES = ["whitened", "unwhitened"]


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
    """Float64 distances in JAX; the probes of mBCG injected into both packages by shape."""
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    monkeypatch.setattr(gpytorch_tpu.linop.base, "probe_base_samples",
                        lambda key, shape, dtype: jnp.asarray(_draw(7, tuple(shape)), dtype=dtype))
    monkeypatch.setattr(gpytorch_tpu_torch.linop.base, "probe_base_samples",
                        lambda shape, dtype, device, source=None: torch.from_numpy(_draw(7, tuple(shape))).to(dtype))


def _mbcg(mod):
    """mBCG everywhere, with solves tight enough that the two packages' CG agree."""
    stack = contextlib.ExitStack()
    for ctx in (mod.max_cholesky_size(0), mod.max_cg_iterations(500), mod.cg_tolerance(1e-12),
                mod.num_trace_samples(6), mod.max_lanczos_quadrature_iterations(40)):
        stack.enter_context(ctx)
    return stack


def _task(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * x[:, 2] + 0.1 * rng.normal(size=n)
    return x, y


# -- the models, one per package ------------------------------------------------------------

def _dist_cls(pkg, dist):
    return {"cholesky": pkg.variational.CholeskyVariationalDistribution,
            "mean_field": pkg.variational.MeanFieldVariationalDistribution,
            "delta": pkg.variational.DeltaVariationalDistribution,
            "natural": pkg.variational.NaturalVariationalDistribution,
            "tril_natural": pkg.variational.TrilNaturalVariationalDistribution}[dist]


def _strategy_cls(pkg, strategy):
    return pkg.variational.VariationalStrategy if strategy == "whitened" else pkg.variational.UnwhitenedVariationalStrategy


def _jax_model(Z, dist, strategy):
    class SVGP(gp.models.ApproximateGP):
        def __init__(self):
            vd = _dist_cls(gp, dist)(Z.shape[-2], dtype=F64)
            super().__init__(_strategy_cls(gp, strategy)(self, jnp.asarray(Z), vd))
            self.mean_module = gp.means.ConstantMean(dtype=F64)
            self.covar_module = gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=D, dtype=F64), dtype=F64)

        def forward(self, x):
            return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    return SVGP()


def _torch_model(Z, dist, strategy):
    class SVGP(gt.models.ApproximateGP):
        def __init__(self):
            vd = _dist_cls(gt, dist)(Z.shape[-2])
            super().__init__(_strategy_cls(gt, strategy)(self, torch.from_numpy(Z), vd))
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D))

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    return SVGP().double()


def _q_state(dist, m, rng):
    """A q(u) away from its initial value: a lower-triangular factor with a positive
    diagonal, natural parameters of a well-conditioned precision."""
    A = rng.normal(size=(m, m)) / np.sqrt(m)
    prec = A @ A.T + np.eye(m)
    name = "variational_strategy._variational_distribution."
    if dist in ("cholesky",):
        L = np.tril(0.3 * rng.normal(size=(m, m)), -1) + np.diag(rng.uniform(0.3, 1.0, size=m))
        return {name + "variational_mean": rng.normal(size=m), name + "chol_variational_covar": L}
    if dist == "mean_field":
        return {name + "variational_mean": rng.normal(size=m), name + "raw_variational_stddev": rng.uniform(0.3, 1, m)}
    if dist == "delta":
        return {name + "variational_mean": rng.normal(size=m)}
    vec = {name + "natural_vec": rng.normal(size=m)}
    if dist == "natural":
        return {**vec, name + "natural_mat": -0.5 * prec}
    return {**vec, name + "natural_tril_mat": np.linalg.cholesky(prec)}


def _params(Z, dist, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "covar_module.raw_outputscale": np.asarray(0.4),
        "covar_module.base_kernel.raw_lengthscale": rng.uniform(-0.8, 0.2, size=(1, D)),
        "mean_module.raw_constant": np.asarray(0.2),
        "variational_strategy.inducing_points": Z + 0.05 * rng.normal(size=Z.shape),
        **_q_state(dist, Z.shape[-2], rng),
    }


LIK_PARAMS = {"noise_covar.raw_noise": np.asarray([-2.0])}


def _pair(dist="cholesky", strategy="whitened", m=M, seed=0):
    """The JAX model and likelihood and the port's, at the same parameters, q(u) initialised."""
    x, _ = _task()
    Z = x[np.random.default_rng(seed).choice(N, m, replace=False)]
    params = _params(Z, dist)
    jm, jl = _jax_model(Z, dist, strategy), gp.likelihoods.GaussianLikelihood(dtype=F64)
    jm(jnp.asarray(x[:4]))  # eager initialisation, then overwritten
    jm = jm.with_params({k: jnp.asarray(v) for k, v in params.items()})
    jl = jl.with_params({k: jnp.asarray(v) for k, v in LIK_PARAMS.items()})
    tm, tl = _torch_model(Z, dist, strategy), gt.likelihoods.GaussianLikelihood().double()
    gt.load_jax_params(tm, {**params, "variational_strategy.variational_params_initialized": 1})
    gt.load_jax_params(tl, LIK_PARAMS)
    return jm, jl, tm, tl, params


# -- operators: closed forms at every size -----------------------------------------------------

def _spd(n, rng, batch=()):
    A = rng.normal(size=batch + (n, n))
    return A @ np.swapaxes(A, -1, -2) / n + np.eye(n)


def _op_pair(kind, n, rng):
    if kind == "identity":
        return gp.linop.IdentityLinearOperator(n, dtype=F64), gt.linop.IdentityLinearOperator(n, torch.float64)
    if kind == "diag":
        d = rng.uniform(0.5, 2.0, size=n)
        return gp.linop.DiagLinearOperator(jnp.asarray(d)), gt.linop.DiagLinearOperator(torch.from_numpy(d))
    if kind == "chol":
        L = np.linalg.cholesky(_spd(n, rng))
        return gp.linop.CholLinearOperator(jnp.asarray(L)), gt.linop.CholLinearOperator(torch.from_numpy(L))
    if kind == "triangular":
        L = np.linalg.cholesky(_spd(n, rng))
        return gp.linop.TriangularLinearOperator(jnp.asarray(L)), gt.linop.TriangularLinearOperator(torch.from_numpy(L))
    L = np.linalg.cholesky(_spd(n // 3, rng, (3,)))
    return (gp.linop.BlockDiagLinearOperator(gp.linop.CholLinearOperator(jnp.asarray(L))),
            gt.linop.BlockDiagLinearOperator(gt.linop.CholLinearOperator(torch.from_numpy(L))))


@pytest.mark.parametrize("kind", ["identity", "diag", "chol", "triangular", "block"])
def test_closed_form_operators_above_max_cholesky_size(kind):
    # n = 12 above max_cholesky_size(4): log-determinant, inverse quadratic form (reduced
    # and not), Cholesky factor and root against the JAX package's closed forms and the
    # dense matrix, 1e-10 relative (the port's base operator would run stochastic mBCG
    # here); expand repeats the operator over a batch
    rng = np.random.default_rng(11)
    jop, top = _op_pair(kind, 12, rng)
    rhs = rng.normal(size=(12, 3))
    dense = np.asarray(jop.to_dense())
    with gp.settings.max_cholesky_size(4), gt.settings.max_cholesky_size(4):
        tiq, tld = top.inv_quad_logdet(torch.from_numpy(rhs), logdet=True)
        tiq_cols, _ = top.inv_quad_logdet(torch.from_numpy(rhs), reduce_inv_quad=False)
        jiq, jld = jop.inv_quad_logdet(jnp.asarray(rhs), logdet=True)
        t_logdet = top.logdet()
        t_chol = top.cholesky().to_dense().numpy()
        t_root = top.root_decomposition().root
    np.testing.assert_allclose([tiq.item(), tld.item(), t_logdet.item()], [float(jiq), float(jld), float(jld)],
                               rtol=1e-10, atol=1e-12)
    if kind != "triangular":  # a triangular operator's quadratic form is rhsᵀ T⁻¹ rhs
        np.testing.assert_allclose(tiq_cols.numpy(), np.einsum("ij,ij->j", rhs, np.linalg.solve(dense, rhs)), rtol=1e-10)
        np.testing.assert_allclose(tld.item(), np.linalg.slogdet(dense)[1], rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(t_chol @ t_chol.T, dense, rtol=1e-10, atol=1e-12)
        root = t_root.numpy()
        np.testing.assert_allclose(root @ root.T, dense, rtol=1e-10, atol=1e-12)
    expanded = top.expand(2, 12, 12)
    assert expanded.shape == (2, 12, 12)
    np.testing.assert_allclose(expanded.to_dense().numpy(), np.broadcast_to(dense, (2, 12, 12)), rtol=1e-12)


# -- the KL terms ---------------------------------------------------------------------------------

def _dense_kl(mu_q, S_q, mu_p, S_p):
    n = mu_q.shape[-1]
    diff = mu_p - mu_q
    return 0.5 * (np.trace(np.linalg.solve(S_p, S_q)) + diff @ np.linalg.solve(S_p, diff) - n
                  + np.linalg.slogdet(S_p)[1] - np.linalg.slogdet(S_q)[1])


@pytest.mark.parametrize("dist", ["cholesky", "mean_field"])
def test_whitened_kl_is_exact_above_max_cholesky_size(dist):
    # m = 32 inducing points above max_cholesky_size(16): KL(q ‖ N(0, I)) closed form in both
    # packages and against the dense formula, 1e-10 relative
    jm, _, tm, _, _ = _pair(dist, "whitened", m=32)
    with gp.settings.max_cholesky_size(16), gt.settings.max_cholesky_size(16):
        t_kl = tm.variational_strategy.kl_divergence(model=tm).item()
        j_kl = float(jax.jit(lambda: jm.variational_strategy.kl_divergence(model=jm))())
    q = tm.variational_strategy.variational_distribution
    exact = _dense_kl(q.mean.detach().numpy(), q.covariance_matrix.detach().numpy(), np.zeros(32), np.eye(32))
    np.testing.assert_allclose(t_kl, j_kl, rtol=1e-10)
    np.testing.assert_allclose(t_kl, exact, rtol=1e-10)


@pytest.mark.parametrize("path", ["cholesky", "mbcg"])
def test_unwhitened_kl_matches_jax(path):
    # KL(q ‖ N(μ_Z, K_ZZ + jitter)) by the dense Cholesky factor (m = 16), and by mBCG with
    # injected probes under max_cholesky_size(0), each against the JAX package at 1e-8;
    # the Cholesky one also against the dense formula, its prior covariance with the 1e-8
    # that psd_safe_cholesky adds in both packages
    jm, _, tm, _, _ = _pair("cholesky", "unwhitened")
    stack = (lambda: contextlib.ExitStack()) if path == "cholesky" else None
    with (_mbcg(gp.settings) if stack is None else stack()), (_mbcg(gt.settings) if stack is None else stack()):
        t_kl = tm.variational_strategy.kl_divergence(model=tm)
        j_kl = jax.jit(lambda: jm.variational_strategy.kl_divergence(model=jm))()
    np.testing.assert_allclose(t_kl.item(), float(j_kl), rtol=RTOL)
    if path == "cholesky":
        q, p = tm.variational_strategy.variational_distribution, tm.variational_strategy.prior_distribution(tm)
        mu_q, S_q, mu_p, S_p = (a.detach().numpy() for a in (q.mean, q.covariance_matrix, p.mean, p.covariance_matrix))
        exact = _dense_kl(mu_q, S_q, mu_p, S_p + 1e-8 * np.eye(M))
        np.testing.assert_allclose(t_kl.item(), exact, rtol=1e-10)


# -- q(f) -------------------------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("dist", DISTS)
def test_variational_forward_matches_jax(dist, strategy):
    # q(f) at 40 points given the same q(u): its mean, covariance and the KL, 1e-8 relative
    x, _ = _task()
    jm, _, tm, _, _ = _pair(dist, strategy)
    xs = x[:40]

    @jax.jit
    def jax_side(xs):
        out = jm(xs)
        return out.mean, out.covariance_matrix, jm.variational_strategy.kl_divergence(model=jm)

    jmean, jcov, jkl = jax_side(jnp.asarray(xs))
    with torch.no_grad():
        out = tm(torch.from_numpy(xs))
        tkl = tm.variational_strategy.kl_divergence(model=tm)
    scale = np.abs(np.asarray(jcov)).max()
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(jmean), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(out.covariance_matrix.numpy(), np.asarray(jcov), rtol=RTOL, atol=RTOL * scale)
    np.testing.assert_allclose(out.variance.numpy(), np.diagonal(np.asarray(jcov)).clip(1e-10), rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_allclose(tkl.item(), float(jkl), rtol=RTOL)


def test_prior_call_and_batched_inputs():
    # model(x, prior=True) is the model's own prior; inputs of shape (b, n, d) broadcast the
    # inducing points to the batch and give one q(f) per element, each the unbatched one
    x, _ = _task()
    _, _, tm, _, _ = _pair()
    xs = torch.from_numpy(x[:20])
    with torch.no_grad():
        prior = tm(xs, prior=True)
        np.testing.assert_allclose(prior.mean.numpy(), tm.forward(xs).mean.numpy())
        batched = tm(torch.stack([xs, xs.flip(0)]))
        single = tm(xs.flip(0))
    assert batched.mean.shape == (2, 20)
    np.testing.assert_allclose(batched.mean[1].numpy(), single.mean.numpy(), rtol=1e-12)
    np.testing.assert_allclose(batched.covariance_matrix[1].numpy(), single.covariance_matrix.numpy(), rtol=1e-10,
                               atol=1e-12)


# -- natural gradients ----------------------------------------------------------------------------

def test_natural_backward_matches_jax_vjp():
    # (S⁻¹μ, −½S⁻¹) → (μ, Σ) on a batch of 2, m = 8, and its backward (the expectation-parameter
    # gradients μ̄ − 2Σ̄μ and sym(Σ̄)) against jax.vjp of the JAX package's custom VJP, 1e-10
    # relative; then through TrilNatural's −½WWᵀ by autograd against jax.vjp of the same map
    rng = np.random.default_rng(5)
    prec = _spd(8, rng, (2,))
    vec, mat = rng.normal(size=(2, 8)), -0.5 * prec
    mu_bar, sigma_bar = rng.normal(size=(2, 8)), rng.normal(size=(2, 8, 8))
    (jmu, jsig), vjp = jax.vjp(_natural_to_mu_sigma, jnp.asarray(vec), jnp.asarray(mat))
    jv, jmat = vjp((jnp.asarray(mu_bar), jnp.asarray(sigma_bar)))
    tv, tmat = torch.from_numpy(vec).requires_grad_(), torch.from_numpy(mat).requires_grad_()
    tmu, tsig = gt.variational.natural_to_mu_sigma(tv, tmat)
    torch.autograd.backward([tmu, tsig], [torch.from_numpy(mu_bar), torch.from_numpy(sigma_bar)])
    np.testing.assert_allclose(tmu.detach().numpy(), np.asarray(jmu), rtol=1e-10)
    np.testing.assert_allclose(tsig.detach().numpy(), np.asarray(jsig), rtol=1e-10)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jv), rtol=1e-10)
    np.testing.assert_allclose(tmat.grad.numpy(), np.asarray(jmat), rtol=1e-10)
    sym = 0.5 * (sigma_bar + np.swapaxes(sigma_bar, -1, -2))
    np.testing.assert_allclose(tv.grad.numpy(), mu_bar - 2 * np.einsum("bij,bj->bi", sym, tmu.detach().numpy()),
                               rtol=1e-10)
    W = np.linalg.cholesky(prec)

    def tril_map(v, W):
        Wl = jnp.tril(W)
        return _natural_to_mu_sigma(v, -0.5 * Wl @ jnp.swapaxes(Wl, -1, -2))

    _, vjp = jax.vjp(tril_map, jnp.asarray(vec), jnp.asarray(W))
    jv, jW = vjp((jnp.asarray(mu_bar), jnp.asarray(sigma_bar)))
    tW, tv = torch.from_numpy(W).requires_grad_(), torch.from_numpy(vec).requires_grad_()
    Wl = torch.tril(tW)
    tmu, tsig = gt.variational.natural_to_mu_sigma(tv, -0.5 * Wl @ Wl.mT)
    torch.autograd.backward([tmu, tsig], [torch.from_numpy(mu_bar), torch.from_numpy(sigma_bar)])
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jv), rtol=1e-10)
    np.testing.assert_allclose(tW.grad.numpy(), np.asarray(jW), rtol=1e-10, atol=1e-12)


def test_ngd_step_is_lr_num_data_times_the_gradient():
    # one NGD step: p ← p − lr·num_data·∇p, the JAX package's optax transformation on the
    # same gradients; parameters without a gradient stay
    rng = np.random.default_rng(6)
    p0, g = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    p, idle = torch.nn.Parameter(torch.from_numpy(p0.copy())), torch.nn.Parameter(torch.zeros(2, dtype=torch.float64))
    p.grad = torch.from_numpy(g.copy())
    gt.optim.NGD([p, idle], num_data=50, lr=0.1).step()
    opt = gp.optim.ngd(0.1, 50)
    updates, _ = opt.update(jnp.asarray(g), opt.init(jnp.asarray(p0)))
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(optax.apply_updates(jnp.asarray(p0), updates)), rtol=1e-14)
    np.testing.assert_allclose(p.detach().numpy(), p0 - 0.1 * 50 * g, rtol=1e-14)
    assert not idle.detach().any()


# -- the objectives ---------------------------------------------------------------------------------

def _split(params):
    return ({k[2:]: v for k, v in params.items() if k.startswith("m.")},
            {k[2:]: v for k, v in params.items() if k.startswith("l.")})


def _jax_objective(jm, jl, mll, x, y, **kwargs):
    """jit(value_and_grad) of the JAX objective in the model's ("m.") and likelihood's ("l.")
    parameters."""
    mll_cls = {"elbo": gp.mlls.VariationalELBO, "gamma": gp.mlls.GammaRobustVariationalELBO,
               "pll": gp.mlls.PredictiveLogLikelihood}[mll]

    def f(p):
        pm, pl = _split(p)
        m, lik = jm.with_params(pm), jl.with_params(pl)
        return mll_cls(lik, m, num_data=N, **kwargs)(m(x), y)

    return jax.jit(jax.value_and_grad(f))


def _torch_objective(tm, tl, mll, x, y, **kwargs):
    mll_cls = {"elbo": gt.mlls.VariationalELBO, "gamma": gt.mlls.GammaRobustVariationalELBO,
               "pll": gt.mlls.PredictiveLogLikelihood}[mll]
    return mll_cls(tl, tm, num_data=N, **kwargs)(tm(x), y)


def _all_params(params):
    return {**{f"m.{k}": jnp.asarray(v) for k, v in params.items()},
            **{f"l.{k}": jnp.asarray(v) for k, v in LIK_PARAMS.items()}}


def _torch_grads(tm, tl):
    return {**{f"m.{k}": p.grad.numpy() for k, p in tm.named_parameters()},
            **{f"l.{k}": p.grad.numpy() for k, p in tl.named_parameters()}}


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mll", ["elbo", "gamma", "pll"])
def test_objective_and_gradients_match_jax(mll, strategy):
    # the objective on all 128 points and its gradient in every parameter (inducing points,
    # q(u), mean, kernel, noise) against jax.grad, 1e-8 relative to the largest gradient
    x, y = _task()
    jm, jl, tm, tl, params = _pair("cholesky", strategy)
    jval, jgrad = _jax_objective(jm, jl, mll, jnp.asarray(x), jnp.asarray(y))(_all_params(params))
    val = _torch_objective(tm, tl, mll, torch.from_numpy(x), torch.from_numpy(y))
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=RTOL)
    tgrad = _torch_grads(tm, tl)
    assert set(tgrad) == set(jgrad)
    scale = max(np.abs(np.asarray(g)).max() for g in jgrad.values())
    for k, g in jgrad.items():
        np.testing.assert_allclose(tgrad[k], np.asarray(g), rtol=RTOL, atol=RTOL * scale, err_msg=k)


class _OutputscalePenalty:
    """An added loss term: 0.01 times the squared outputscale."""

    def __init__(self, kernel):
        self.kernel = kernel

    def loss(self):
        return 0.01 * self.kernel.outputscale ** 2


def test_terms_priors_and_added_losses_match_jax():
    # combine_terms=False gives (likelihood term, KL term, prior term), and a fourth, the
    # added loss, where the model has one; a Gamma prior on the lengthscale enters as
    # log p / num_data.  Each term against the JAX package at 1e-8
    x, y = _task()
    jm, jl, tm, tl, params = _pair("cholesky", "whitened")
    for pkg, model in ((gp, jm), (gt, tm)):  # float64 hyperparameters in both packages
        model.covar_module.base_kernel.register_prior(
            "lengthscale_prior", pkg.priors.GammaPrior(np.float64(3.0), np.float64(6.0)), "lengthscale")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jax_terms = jax.jit(lambda x, y: gp.mlls.VariationalELBO(jl, jm, num_data=N, combine_terms=False)(jm(x), y))
    j_terms = jax_terms(jnp.asarray(x), jnp.asarray(y))
    t_terms = gt.mlls.VariationalELBO(tl, tm, num_data=N, combine_terms=False)(tm(tx), ty)
    assert len(t_terms) == len(j_terms) == 3
    np.testing.assert_allclose([t.item() for t in t_terms], [float(t) for t in j_terms], rtol=RTOL)
    assert t_terms[2].item() != 0.0
    for model in (jm, tm):
        model.covar_module.register_added_loss_term("scale")
        model.covar_module.update_added_loss_term("scale", _OutputscalePenalty(model.covar_module))
    jax_terms = jax.jit(lambda x, y: gp.mlls.VariationalELBO(jl, jm, num_data=N, combine_terms=False)(jm(x), y))
    j_terms = jax_terms(jnp.asarray(x), jnp.asarray(y))
    t_terms = gt.mlls.VariationalELBO(tl, tm, num_data=N, combine_terms=False)(tm(tx), ty)
    assert len(t_terms) == len(j_terms) == 4
    np.testing.assert_allclose([t.item() for t in t_terms], [float(t) for t in j_terms], rtol=RTOL)
    combined = gt.mlls.VariationalELBO(tl, tm, num_data=N)(tm(tx), ty)
    np.testing.assert_allclose(combined.item(), (t_terms[0] - t_terms[1] + t_terms[2] - t_terms[3]).item(), rtol=1e-12)


def test_adam_and_ngd_steps_match_jax():
    # 4 steps: NGD (lr 0.1, num_data = N) on the natural parameters and Adam (lr 0.01) on the
    # rest, split by name, on minibatches of 32; every parameter after them against the JAX
    # package (optax.multi_transform of ngd and adam), 1e-8 relative to its largest value
    x, y = _task()
    jm, jl, tm, tl, params = _pair("natural", "whitened")
    is_natural = lambda k: "_variational_distribution.natural" in k  # noqa: E731
    p = _all_params(params)
    opt = optax.multi_transform({"ngd": gp.optim.ngd(0.1, N), "adam": optax.adam(0.01)},
                                {k: "ngd" if is_natural(k) else "adam" for k in p})
    state = opt.init(p)

    @jax.jit
    def step(p, s, xb, yb):
        def loss(p):
            pm, pl = _split(p)
            m, lik = jm.with_params(pm), jl.with_params(pl)
            return -gp.mlls.VariationalELBO(lik, m, num_data=N)(m(xb), yb)

        g = jax.grad(loss)(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    named = dict(tm.named_parameters())
    ngd = gt.optim.NGD([v for k, v in named.items() if is_natural(k)], num_data=N, lr=0.1)
    adam = torch.optim.Adam([v for k, v in named.items() if not is_natural(k)] + list(tl.parameters()), lr=0.01)
    for i in range(4):
        sl = slice(32 * i, 32 * (i + 1))
        p, state = step(p, state, jnp.asarray(x[sl]), jnp.asarray(y[sl]))
        ngd.zero_grad(), adam.zero_grad()
        loss = -gt.mlls.VariationalELBO(tl, tm, num_data=N)(tm(torch.from_numpy(x[sl])), torch.from_numpy(y[sl]))
        loss.backward()
        ngd.step(), adam.step()
    final = {**{f"m.{k}": v.detach().numpy() for k, v in tm.named_parameters()},
             **{f"l.{k}": v.detach().numpy() for k, v in tl.named_parameters()}}
    for k, v in p.items():
        np.testing.assert_allclose(final[k], np.asarray(v), rtol=RTOL, atol=RTOL * np.abs(np.asarray(v)).max(), err_msg=k)


# -- Monte Carlo expectations of the base likelihood ---------------------------------------------

def test_monte_carlo_expectations_agree_with_closed_forms():
    # the base class's Monte Carlo E_q[log p(y|f)] and log E_q[p(y|f)] of a Gaussian
    # likelihood, from 20,000 draws of q(f) at 8 points (base samples from a seeded
    # generator), against the closed forms within 5 standard errors of the estimate
    rng = np.random.default_rng(9)
    mean, y = torch.from_numpy(rng.normal(size=8)), torch.from_numpy(rng.normal(size=8))
    cov = torch.from_numpy(_spd(8, rng) * 0.2)
    q = gt.distributions.MultivariateNormal(mean, cov)
    lik = gt.likelihoods.GaussianLikelihood().double()
    lik.noise = 0.3
    gen = torch.Generator().manual_seed(0)
    with gt.settings.num_likelihood_samples(20_000):
        draws = lik._draw_likelihood_samples(q, base_samples=gen).log_prob(y)
        gen.manual_seed(0)
        mc_elp = gt.likelihoods.Likelihood.expected_log_prob(lik, y, q, base_samples=gen)
        gen.manual_seed(0)
        mc_lm = gt.likelihoods.Likelihood.log_marginal(lik, y, q, base_samples=gen)
    assert draws.shape == (20_000, 8)
    se_elp = draws.std(0) / np.sqrt(20_000)
    p = draws.exp()
    se_lm = p.std(0) / (p.mean(0) * np.sqrt(20_000))  # the delta method for log of the mean
    assert (mc_elp - lik.expected_log_prob(y, q)).abs().le(5 * se_elp).all()
    assert (mc_lm - lik.log_marginal(y, q)).abs().le(5 * se_lm).all()
    jl = gp.likelihoods.GaussianLikelihood(dtype=F64).with_params(
        {"noise_covar.raw_noise": jnp.asarray(lik.noise_covar.raw_noise.detach().numpy())})
    jq = gp.distributions.MultivariateNormal(jnp.asarray(mean.numpy()), jnp.asarray(cov.numpy()))
    for t_val, j_val in ((lik.log_marginal(y, q), jl.log_marginal(jnp.asarray(y.numpy()), jq)),
                         (lik.expected_log_prob(y, q), jl.expected_log_prob(jnp.asarray(y.numpy()), jq))):
        np.testing.assert_allclose(t_val.detach().numpy(), np.asarray(j_val), rtol=1e-12)


# -- carrying the weights across --------------------------------------------------------------------

def test_load_jax_params_carries_the_initialised_flag():
    # with the flag, the loaded q(u) survives the first call; without it, the first call
    # initialises q(u) from the prior (the whitened prior's identity factor), as a fresh
    # model does
    x, _ = _task()
    Z = x[:M]
    params = _params(Z, "cholesky")
    name = "variational_strategy._variational_distribution.chol_variational_covar"
    for flag in (1, 0):
        tm = _torch_model(Z, "cholesky", "whitened")
        extra = {"variational_strategy.variational_params_initialized": flag} if flag else {}
        gt.load_jax_params(tm, {**params, **extra})
        assert int(tm.variational_strategy.variational_params_initialized) == flag
        with torch.no_grad():
            tm(torch.from_numpy(x[:4]))
        got = dict(tm.named_parameters())[name].detach().numpy()
        np.testing.assert_allclose(got, params[name] if flag else np.eye(M), rtol=1e-12)
        assert int(tm.variational_strategy.variational_params_initialized) == 1


def test_chip_smoke_svgp_parity_constant():
    # chip_smoke.py's phase 14 gates the card's ELBO and KL term at its parity state against
    # the stored SVGP_ELBO_JAX and SVGP_KL_JAX: those constants are the JAX package's float64
    # values there (recomputed, 1e-12 relative), and the port on the CPU reads them within
    # the gates' tolerances in float64 and float32 (m = 1,024 inducing points, a minibatch of
    # 1,024)
    import chip_smoke as cs
    from svgp_elbo_reference import jax_terms

    np.testing.assert_allclose(jax_terms(), (cs.SVGP_ELBO_JAX, cs.SVGP_KL_JAX), rtol=1e-12)
    for dtype, elbo_tol, kl_tol in zip((torch.float32, torch.float64), cs.SVGP_ELBO_TOL, cs.SVGP_KL_TOL):
        elbo, kl = cs.svgp_parity_terms("cpu", dtype)
        np.testing.assert_allclose(elbo, cs.SVGP_ELBO_JAX, rtol=elbo_tol)
        np.testing.assert_allclose(kl, cs.SVGP_KL_JAX, rtol=kl_tol)
