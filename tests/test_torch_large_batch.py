"""The port's large-batch variational strategy against the JAX package, in float64 on the CPU.

``quad_form_diagonal`` (diag(Rᵀ M R) with the JAX package's VJP) against ``jax.grad`` of the
JAX function, and ``LargeBatchVariationalStrategy`` in an SVGP (ConstantMean,
ScaleKernel(RBFKernel(ard_num_dims=3)), GaussianLikelihood, a Cholesky q(u) on m = 16
inducing points, 128 points of a 3-input task): the ELBO and its gradient in every
parameter against ``jax.grad``, the eval-mode q(f) against the JAX package's, and the same
state's ELBO through ``VariationalStrategy``, which computes the same function.  The state
goes into the port by ``load_jax_params`` with ``variational_params_initialized`` = 1; the
JAX side has float64 distances and is ``jax.jit``ted.

Tolerances: 1e-12 relative for the quadratic form (the same products), 1e-8 relative for the
strategy (both packages' triangular solves on K_ZZ + 1e-6·I, in another order), 1e-9 between
the two strategies (the grouped middle term against two separate solves).  Last, the port's
float32 gradient against float64 with the middle term in float64 (the port's choice, as
GPyTorch's on a GPU) and in float32 (the JAX package's dtype), on an ill-conditioned state.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt
from gpytorch_tpu.variational.large_batch_variational_strategy import quad_form_diagonal as jax_qfd

D, N, M = 3, 128, 16
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


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)


def _task(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * x[:, 2] + 0.1 * rng.normal(size=n)
    return x, y


@pytest.mark.parametrize("batch", [(), (2,)])
def test_quad_form_diagonal_and_its_backward_match_jax(batch):
    # diag(Rᵀ M R) for a symmetric M (m = 7) and R (7, 11), with and without a batch, and its
    # gradients in M and R for a random cotangent, against jax.grad of the JAX package's
    # custom VJP, 1e-12 relative; the backward is the VJP's, not autograd's of the product
    rng = np.random.default_rng(1)
    A = rng.normal(size=batch + (7, 7))
    M_, R = A + np.swapaxes(A, -1, -2), rng.normal(size=batch + (7, 11))
    d = rng.normal(size=batch + (11,))
    j_val = jax_qfd(jnp.asarray(M_), jnp.asarray(R))
    j_dM, j_dR = jax.grad(lambda m, r: jnp.sum(jax_qfd(m, r) * jnp.asarray(d)), argnums=(0, 1))(
        jnp.asarray(M_), jnp.asarray(R))
    tM, tR = torch.from_numpy(M_).requires_grad_(), torch.from_numpy(R).requires_grad_()
    t_val = gt.variational.quad_form_diagonal(tM, tR)
    (t_val * torch.from_numpy(d)).sum().backward()
    np.testing.assert_allclose(t_val.detach().numpy(), np.asarray(j_val), rtol=1e-12)
    np.testing.assert_allclose(t_val.detach().numpy(), np.einsum("...mi,...mk,...ki->...i", R, M_, R), rtol=1e-12)
    np.testing.assert_allclose(tM.grad.numpy(), np.asarray(j_dM), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tR.grad.numpy(), np.asarray(j_dR), rtol=1e-12, atol=1e-14)


def _models(pkg, Z, strategy):
    cls = {"large": pkg.variational.LargeBatchVariationalStrategy, "whitened": pkg.variational.VariationalStrategy}[
        strategy]
    kw = {"dtype": F64} if pkg is gp else {}

    class SVGP(pkg.models.ApproximateGP):
        def __init__(self):
            vd = pkg.variational.CholeskyVariationalDistribution(Z.shape[-2], **kw)
            super().__init__(cls(self, jnp.asarray(Z) if pkg is gp else torch.from_numpy(Z), vd))
            self.mean_module = pkg.means.ConstantMean(**kw)
            self.covar_module = pkg.kernels.ScaleKernel(pkg.kernels.RBFKernel(ard_num_dims=D, **kw), **kw)

        def forward(self, x):
            return pkg.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    return SVGP()


def _state(Z, seed=3):
    rng = np.random.default_rng(seed)
    m = Z.shape[0]
    L = np.tril(0.3 * rng.normal(size=(m, m)), -1) + np.diag(rng.uniform(0.3, 1.0, size=m))
    name = "variational_strategy._variational_distribution."
    return {"covar_module.raw_outputscale": np.asarray(0.4),
            "covar_module.base_kernel.raw_lengthscale": rng.uniform(-0.8, 0.2, size=(1, D)),
            "mean_module.raw_constant": np.asarray(0.2),
            "variational_strategy.inducing_points": Z + 0.05 * rng.normal(size=Z.shape),
            name + "variational_mean": rng.normal(size=m), name + "chol_variational_covar": L}


LIK = {"noise_covar.raw_noise": np.asarray([-2.0])}


def _pair(strategy="large"):
    x, _ = _task()
    Z = x[np.random.default_rng(0).choice(N, M, replace=False)]
    params = _state(Z)
    jm, jl = _models(gp, Z, strategy), gp.likelihoods.GaussianLikelihood(dtype=F64)
    jm(jnp.asarray(x[:4]))  # eager initialisation, then overwritten
    jm = jm.with_params({k: jnp.asarray(v) for k, v in params.items()})
    jl = jl.with_params({k: jnp.asarray(v) for k, v in LIK.items()})
    tm, tl = _models(gt, Z, strategy).double(), gt.likelihoods.GaussianLikelihood().double()
    gt.load_jax_params(tm, {**params, "variational_strategy.variational_params_initialized": 1})
    gt.load_jax_params(tl, LIK)
    return jm, jl, tm, tl, params


def _jax_elbo(jm, jl, x, y):
    def f(p):
        m = jm.with_params({k[2:]: v for k, v in p.items() if k.startswith("m.")})
        lik = jl.with_params({k[2:]: v for k, v in p.items() if k.startswith("l.")})
        return gp.mlls.VariationalELBO(lik, m, num_data=N)(m(x), y)

    return jax.jit(jax.value_and_grad(f))


def test_elbo_and_gradients_match_jax_and_the_whitened_strategy():
    # the ELBO on all 128 points (training mode: the diagonal by quad_form_diagonal) and its
    # gradient in every parameter against jax.grad, 1e-8 relative to the largest gradient;
    # the same state through VariationalStrategy gives the same ELBO and gradients (1e-9)
    x, y = _task()
    jm, jl, tm, tl, params = _pair("large")
    p = {**{f"m.{k}": jnp.asarray(v) for k, v in params.items()}, **{f"l.{k}": jnp.asarray(v) for k, v in LIK.items()}}
    jval, jgrad = _jax_elbo(jm, jl, jnp.asarray(x), jnp.asarray(y))(p)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    val = gt.mlls.VariationalELBO(tl, tm, num_data=N)(tm(tx), ty)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=RTOL)
    tgrad = {**{f"m.{k}": q.grad.numpy() for k, q in tm.named_parameters()},
             **{f"l.{k}": q.grad.numpy() for k, q in tl.named_parameters()}}
    assert set(tgrad) == set(jgrad)
    scale = max(np.abs(np.asarray(g)).max() for g in jgrad.values())
    for k, g in jgrad.items():
        np.testing.assert_allclose(tgrad[k], np.asarray(g), rtol=RTOL, atol=RTOL * scale, err_msg=k)
    _, _, wm, wl, _ = _pair("whitened")
    wval = gt.mlls.VariationalELBO(wl, wm, num_data=N)(wm(tx), ty)
    wval.backward()
    np.testing.assert_allclose(wval.item(), val.item(), rtol=1e-9)
    for k, q in wm.named_parameters():
        np.testing.assert_allclose(q.grad.numpy(), tgrad[f"m.{k}"], rtol=1e-9, atol=1e-9 * scale, err_msg=k)


def test_eval_predictions_match_jax():
    # eval mode: q(f) at 40 points (the lazy sum K_xx + K_xZ (M K_Zx)), mean and covariance
    # against the JAX package's, 1e-8 relative; the training-mode diagonal equals the eval
    # covariance's diagonal
    x, _ = _task()
    jm, _, tm, _, _ = _pair("large")
    xs = x[:40]
    jm = jm.eval()
    jmean, jcov = jax.jit(lambda xs: (jm(xs).mean, jm(xs).covariance_matrix))(jnp.asarray(xs))
    with torch.no_grad():
        train_var = tm(torch.from_numpy(xs)).variance
        tm.eval()
        out = tm(torch.from_numpy(xs))
    scale = np.abs(np.asarray(jcov)).max()
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(jmean), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(out.covariance_matrix.numpy(), np.asarray(jcov), rtol=RTOL, atol=RTOL * scale)
    np.testing.assert_allclose(train_var.numpy(), np.diagonal(out.covariance_matrix.numpy()), rtol=1e-10,
                               atol=1e-12 * scale)


def test_float32_gradients_take_the_wide_middle_term():
    # in float32, with K_ZZ + 1e-4·I ill-conditioned (m = 128 points of the unit cube, ℓ ≈
    # 0.69) and S far from I, the grouped L⁻ᵀ(S − I)L⁻¹ amplifies round-off: computed in the
    # inputs' dtype (settings._linalg_dtype_cholesky(None), as the JAX package does) the
    # ELBO's gradient reads 0.18 of its largest entry off float64; in float64 (the default)
    # 5.8e-05, as the whitened strategy's float32 gradient (5.5e-05).  Gates 1e-3 and 1e-2
    rng = np.random.default_rng(0)
    m, n = 128, 512
    x = rng.uniform(size=(n, D))
    y = np.sin(4 * x[:, 0]) + 0.1 * rng.normal(size=n)
    r2 = np.random.default_rng(1)
    name = "variational_strategy._variational_distribution."
    state = {"variational_strategy.inducing_points": x[:m], name + "variational_mean": r2.normal(size=m),
             name + "chol_variational_covar": np.tril(0.3 * r2.normal(size=(m, m)), -1) + np.diag(r2.uniform(0.3, 1, m)),
             "covar_module.raw_outputscale": np.asarray(0.5), "covar_module.base_kernel.raw_lengthscale": np.zeros((1, D)),
             "mean_module.raw_constant": np.asarray(0.0), "variational_strategy.variational_params_initialized": 1}

    def grads(strategy, dtype, wide=torch.float64):
        tm = _models(gt, x[:m], strategy)
        tm.variational_strategy._jitter_val = 1e-4
        gt.load_jax_params(tm.to(dtype), state)
        tl = gt.likelihoods.GaussianLikelihood().to(dtype)
        with gt.settings._linalg_dtype_cholesky(wide):
            gt.mlls.VariationalELBO(tl, tm, num_data=n)(tm(torch.from_numpy(x).to(dtype)),
                                                        torch.from_numpy(y).to(dtype)).backward()
        return {k: p.grad.double() for k, p in tm.named_parameters()}

    ref = grads("whitened", torch.float64)
    scale = max(g.abs().max().item() for g in ref.values())

    def gap(g):
        return max((g[k] - ref[k]).abs().max().item() for k in ref) / scale

    assert gap(grads("large", torch.float32)) <= 1e-3
    assert gap(grads("large", torch.float32, wide=None)) > 1e-2
    assert gap(grads("whitened", torch.float32)) <= 1e-3


def test_float32_eval_forms_the_wide_correction():
    # eval mode in float32: K_xZ M K_Zx formed in float64 and cast (a dense operator), its
    # covariance within 1e-5 of the float64 model's largest entry, the mean within 1e-5 (the
    # jitter fixed: by default it follows the dtype); in float64 it stays the lazy product of
    # the JAX package
    x, _ = _task()
    _, _, tm, _, _ = _pair("large")
    tm.variational_strategy._jitter_val = 1e-4
    tm.eval()
    xs = torch.from_numpy(x[:40])
    with torch.no_grad():
        ref = tm(xs)
        assert isinstance(ref.lazy_covariance_matrix.ops[-1], gt.linop.MatmulLinearOperator)
        out = tm.float()(xs.float())
    assert isinstance(out.lazy_covariance_matrix.ops[-1], gt.linop.DenseLinearOperator)
    scale = ref.covariance_matrix.abs().max().item()
    np.testing.assert_allclose(out.covariance_matrix.double().numpy(), ref.covariance_matrix.numpy(), atol=1e-5 * scale)
    np.testing.assert_allclose(out.mean.double().numpy(), ref.mean.numpy(), atol=1e-5 * ref.mean.abs().max().item())
