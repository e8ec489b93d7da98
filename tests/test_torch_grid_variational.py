"""The port's grid-interpolation variational strategies against the JAX package, in float64
on the CPU.

``GridInterpolationVariationalStrategy`` on an 8 × 8 grid over [0, 1]² (64 inducing values,
a Cholesky q(u)) and ``AdditiveGridInterpolationVariationalStrategy`` on one 1-D grid of 16
points over [0, 1] for 3 input dimensions (q(u) batched over them), with and without
``mixing_params`` and ``sum_output``, in an SVGP (ConstantMean, ScaleKernel(RBFKernel()),
GaussianLikelihood) on 48 points.  The ELBO (summed over the dimensions without
``sum_output``), the KL and the gradient of the ELBO in every parameter against ``jax.grad``,
and q(f).  The KL of the unwhitened prior N(μ_U, K_UU + 1e-3·I) is taken by the dense Cholesky
factor (m ≤ 800), and under ``max_cholesky_size(0)`` by mBCG with probes injected into both
packages by shape.  The JAX package keeps its grid in float32 even under x64: the port takes
it with ``load_jax_params(..., {"variational_strategy.grid": ...})``, so that both interpolate
on the same points.

Also here: the additive prior's products fold the 3 repeated elements into the columns of
one fused product (``BatchRepeatLinearOperator``), whose backward is one fused symmetric pass.

Tolerance: 1e-8 relative on both paths.  The mBCG path runs CG at tolerance 1e-12 with up to
100 Lanczos quadrature iterations, more than m: with 40 the 2-D grid's tridiagonals are cut
short and the two packages' SLQ estimates read 5e-8 apart, with 100 they read 3e-10 apart.
"""

import contextlib
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

N, D = 48, 3
RTOL = 1e-8
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
    stack = contextlib.ExitStack()
    for ctx in (mod.max_cholesky_size(0), mod.max_cg_iterations(500), mod.cg_tolerance(1e-12),
                mod.num_trace_samples(6), mod.max_lanczos_quadrature_iterations(100)):
        stack.enter_context(ctx)
    return stack


def _task(kind="additive", seed=0):
    """48 points in [0.05, 0.95]³ and their targets; the 2-D grid takes the first two inputs."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.05, 0.95, size=(N, D))
    y = np.sin(4 * x[:, 0]) + np.cos(3 * x[:, 1]) + x[:, 2] + 0.1 * rng.normal(size=N)
    return (x[:, :2] if kind == "grid" else x), y


def _models(pkg, kind, mixing=False, sum_output=True):
    kw = {"dtype": F64} if pkg is gp else {}

    class GridSVGP(pkg.models.ApproximateGP):
        def __init__(self):
            if kind == "grid":
                vd = pkg.variational.CholeskyVariationalDistribution(64, **kw)
                strategy = pkg.variational.GridInterpolationVariationalStrategy(self, 8, [(0.0, 1.0), (0.0, 1.0)], vd)
            else:
                vd = pkg.variational.CholeskyVariationalDistribution(16, batch_shape=(D,), **kw)
                strategy = pkg.variational.AdditiveGridInterpolationVariationalStrategy(
                    self, 16, [(0.0, 1.0)], D, vd, mixing_params=mixing, sum_output=sum_output)
            super().__init__(strategy)
            self.mean_module = pkg.means.ConstantMean(**kw)
            self.covar_module = pkg.kernels.ScaleKernel(pkg.kernels.RBFKernel(**kw), **kw)

        def forward(self, x):
            return pkg.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    return GridSVGP()


def _perturbed(params, seed, lengthscale):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v, dtype=np.float64)
        if k.endswith("chol_variational_covar"):
            m = v.shape[-1]
            v = np.tril(0.1 * rng.normal(size=v.shape), -1) + np.eye(m) * rng.uniform(0.3, 1.0, size=v.shape[:-1] + (1,))
        elif k.endswith("mixing_params"):
            v = rng.uniform(0.5, 1.5, size=v.shape)
        elif k.endswith("raw_lengthscale"):
            v = np.full(v.shape, lengthscale)
        else:
            v = v + 0.3 * rng.normal(size=v.shape)
        out[k] = v
    return out


def _pair(kind, mixing=False, sum_output=True):
    x, _ = _task(kind)
    jm, jl = _models(gp, kind, mixing, sum_output), gp.likelihoods.GaussianLikelihood(dtype=F64)
    jm(jnp.asarray(x[:4]))  # eager initialisation, then overwritten
    # raw lengthscales −1.5 (ℓ ≈ 0.2) on the 8 × 8 grid, −3 (ℓ ≈ 0.05) on the 1-D grid of 16:
    # at ℓ ≈ 0.2 there, K_UU + 1e-3·I is so ill-conditioned that float64 CG stalls (the stall
    # window) 1e-5 short of the dense gradient in both packages, at iterations that rounding
    # picks
    params = _perturbed(jm.trainable_params(), 3, -1.5 if kind == "grid" else -3.0)
    lik_params = {"noise_covar.raw_noise": np.asarray([-2.0])}
    grid = [np.asarray(g) for g in jm.variational_strategy.grids]
    jm = jm.with_params({k: jnp.asarray(v) for k, v in params.items()})
    jl = jl.with_params({k: jnp.asarray(v) for k, v in lik_params.items()})
    tm, tl = _models(gt, kind, mixing, sum_output).double(), gt.likelihoods.GaussianLikelihood().double()
    gt.load_jax_params(tm, {**params, "variational_strategy.variational_params_initialized": 1,
                            "variational_strategy.grid": grid})
    gt.load_jax_params(tl, lik_params)
    return jm, jl, tm, tl, params, lik_params


CASES = [("grid", False, True), ("additive", False, True), ("additive", True, True), ("additive", True, False),
         ("additive", False, False)]


@pytest.mark.parametrize("path", ["cholesky", "mbcg"])
@pytest.mark.parametrize("kind,mixing,sum_output", CASES)
def test_elbo_kl_and_gradients_match_jax(kind, mixing, sum_output, path):
    # the ELBO on the 48 points, its KL term and the ELBO's gradient in every parameter (the
    # mixing parameters included) against jax.grad, 1e-8 relative, on the dense path and on
    # the mBCG path with injected probes
    x, y = _task(kind)
    jm, jl, tm, tl, params, lik_params = _pair(kind, mixing, sum_output)
    rtol = RTOL

    def f(p, x, y):
        m = jm.with_params({k[2:]: v for k, v in p.items() if k.startswith("m.")})
        lik = jl.with_params({k[2:]: v for k, v in p.items() if k.startswith("l.")})
        terms = gp.mlls.VariationalELBO(lik, m, num_data=N, combine_terms=False)(m(x), y)
        return jnp.sum(terms[0] - terms[1] + terms[2]), terms[1]

    p = {**{f"m.{k}": jnp.asarray(v) for k, v in params.items()},
         **{f"l.{k}": jnp.asarray(v) for k, v in lik_params.items()}}
    stack = _mbcg if path == "mbcg" else (lambda mod: contextlib.ExitStack())
    with stack(gp.settings):
        (jval, jkl), jgrad = jax.jit(jax.value_and_grad(f, has_aux=True))(p, jnp.asarray(x), jnp.asarray(y))
    with stack(gt.settings):
        log_lik, kl, log_prior = gt.mlls.VariationalELBO(tl, tm, num_data=N, combine_terms=False)(
            tm(torch.from_numpy(x)), torch.from_numpy(y))
        val = (log_lik - kl + log_prior).sum()
        val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=rtol)
    # the KL is a small difference of its trace, quadratic and log-determinant terms: its
    # rounding is read against the ELBO's size
    np.testing.assert_allclose(kl.item(), float(jkl), rtol=rtol, atol=rtol * abs(float(jval)))
    tgrad = {**{f"m.{k}": q.grad.numpy() for k, q in tm.named_parameters()},
             **{f"l.{k}": q.grad.numpy() for k, q in tl.named_parameters()}}
    assert set(tgrad) == set(jgrad)
    scale = max(np.abs(np.asarray(g)).max() for g in jgrad.values())
    for k, g in jgrad.items():
        np.testing.assert_allclose(tgrad[k], np.asarray(g), rtol=rtol, atol=rtol * scale, err_msg=k)


@pytest.mark.parametrize("kind,mixing,sum_output", CASES)
def test_predictions_match_jax(kind, mixing, sum_output):
    # q(f) at 20 points, mean and covariance (one q(f_d) a dimension without sum_output),
    # 1e-8 relative
    x, _ = _task(kind)
    jm, _, tm, _, _, _ = _pair(kind, mixing, sum_output)
    xs = x[:20]
    jmean, jcov = jax.jit(lambda xs: (jm(xs).mean, jm(xs).covariance_matrix))(jnp.asarray(xs))
    with torch.no_grad():
        out = tm(torch.from_numpy(xs))
    scale = np.abs(np.asarray(jcov)).max()
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(jmean), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(out.covariance_matrix.numpy(), np.asarray(jcov), rtol=RTOL, atol=RTOL * scale)


def test_additive_kl_folds_the_batch_into_one_fused_product():
    # under max_cholesky_size(0) with K_UU kept lazy (max_eager_kernel_size(4)), each mBCG
    # iteration of the additive KL is one fused symmetric product with the 3 elements' columns
    # side by side (no product per element, none streamed by blocks), and its backward one
    # fused symmetric pass; the KL and its gradients equal the dense K_UU's, 1e-9 relative
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    _, _, tm, _, _, _ = _pair("additive", True, True)
    strategy = tm.variational_strategy
    params = [q for q in tm.parameters()]
    with _mbcg(gt.settings):
        kl_dense = strategy.kl_divergence(model=tm)
        grads_dense = torch.autograd.grad(kl_dense, params, allow_unused=True)
    products, backwards = [], []
    product, backward = fk._product, fk._backward

    def counted_product(x1, x2, v, kt):
        products.append((x1.shape[0], x2.shape[0], v.shape[1], x1 is x2))
        return product(x1, x2, v, kt)

    def counted_backward(x1, x2, g, v, kt, symmetric, *args, **kwargs):
        backwards.append((x1.shape[0], v.shape[1], symmetric))
        return backward(x1, x2, g, v, kt, symmetric, *args, **kwargs)

    fk._product, fk._backward = counted_product, counted_backward
    try:
        with _mbcg(gt.settings), gt.settings.max_eager_kernel_size(4):
            kl_lazy = strategy.kl_divergence(model=tm)
            fwd = list(products)
            grads_lazy = torch.autograd.grad(kl_lazy, params, allow_unused=True)
    finally:
        fk._product, fk._backward = product, backward
    t = 16 + 1 + 6  # [L_S | μ_U − m | probes] of each element
    assert fwd and all(shape == (16, 16, D * t, True) for shape in fwd), fwd
    assert backwards == [(16, D * t, True)], backwards
    np.testing.assert_allclose(kl_lazy.item(), kl_dense.item(), rtol=1e-9)
    for g_lazy, g_dense in zip(grads_lazy, grads_dense):
        if g_dense is not None:
            np.testing.assert_allclose(g_lazy.numpy(), g_dense.numpy(), rtol=1e-8, atol=1e-10)
