"""The port's decoupled variational strategies against the JAX package, in float64 on the CPU.

``OrthogonallyDecoupledVariationalStrategy``: 24 mean inducing points with a Delta q(u) over a
whitened ``VariationalStrategy`` (Cholesky q(u), 8 inducing points); and
``BatchDecoupledVariationalStrategy``: 12 inducing points stacked on a batch of 2 with a
kernel of batch shape (2,) (one set of hyperparameters for the mean, one for the variance).
Both in an SVGP (ConstantMean, ScaleKernel(RBFKernel(ard_num_dims=2)), GaussianLikelihood) on
64 points: the ELBO, the KL and the gradient of the ELBO in every parameter (the nested
``base_variational_strategy.*`` names included) against ``jax.grad``, and q(f) in eval mode.
The JAX model's initialised parameters are perturbed with numpy and carried across by
``load_jax_params``.

Tolerance: 1e-8 relative (the same float64 arithmetic in another order).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt

D, N = 2, 64
M_MEAN, M_COVAR, M_BATCH = 24, 8, 12
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


def _task(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(N, D))
    return x, np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.1 * rng.normal(size=N)


def _models(pkg, kind, x):
    kw = {"dtype": F64} if pkg is gp else {}
    arr = jnp.asarray if pkg is gp else torch.from_numpy
    rng = np.random.default_rng(1)
    batch = (2,) if kind == "batch" else ()

    class DecoupledSVGP(pkg.models.ApproximateGP):
        def __init__(self):
            if kind == "orthogonal":
                covar = pkg.variational.VariationalStrategy(
                    self, arr(x[rng.choice(N, M_COVAR, replace=False)]),
                    pkg.variational.CholeskyVariationalDistribution(M_COVAR, **kw))
                strategy = pkg.variational.OrthogonallyDecoupledVariationalStrategy(
                    covar, arr(x[rng.choice(N, M_MEAN, replace=False)]),
                    pkg.variational.DeltaVariationalDistribution(M_MEAN, **kw))
            else:
                strategy = pkg.variational.BatchDecoupledVariationalStrategy(
                    self, arr(x[rng.choice(N, M_BATCH, replace=False)]),
                    pkg.variational.CholeskyVariationalDistribution(M_BATCH, **kw))
            super().__init__(strategy)
            self.mean_module = pkg.means.ConstantMean(**kw)
            self.covar_module = pkg.kernels.ScaleKernel(
                pkg.kernels.RBFKernel(ard_num_dims=D, batch_shape=batch, **kw), batch_shape=batch, **kw)

        def forward(self, x):
            return pkg.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    return DecoupledSVGP()


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v, dtype=np.float64)
        if k.endswith("chol_variational_covar"):
            m = v.shape[-1]
            v = np.tril(0.3 * rng.normal(size=v.shape), -1) + np.diag(rng.uniform(0.3, 1.0, size=m))
        elif k.endswith("inducing_points"):
            v = v + 0.05 * rng.normal(size=v.shape)
        else:
            v = v + 0.3 * rng.normal(size=v.shape)
        out[k] = v
    return out


def _pair(kind):
    x, _ = _task()
    jm, jl = _models(gp, kind, x), gp.likelihoods.GaussianLikelihood(dtype=F64)
    jm(jnp.asarray(x[:4]))  # eager initialisation, then overwritten
    params = _perturbed(jm.trainable_params(), 2)
    lik_params = {"noise_covar.raw_noise": np.asarray([-2.0])}
    jm = jm.with_params({k: jnp.asarray(v) for k, v in params.items()})
    jl = jl.with_params({k: jnp.asarray(v) for k, v in lik_params.items()})
    tm, tl = _models(gt, kind, x).double(), gt.likelihoods.GaussianLikelihood().double()
    flags = {"variational_strategy.variational_params_initialized": 1}
    if kind == "orthogonal":
        flags["variational_strategy.base_variational_strategy.variational_params_initialized"] = 1
    gt.load_jax_params(tm, {**params, **flags})
    gt.load_jax_params(tl, lik_params)
    return jm, jl, tm, tl, params, lik_params


@pytest.mark.parametrize("kind", ["orthogonal", "batch"])
def test_elbo_kl_and_gradients_match_jax(kind):
    # the ELBO on the 64 points, its KL term, and the ELBO's gradient in every parameter
    # against jax.grad, 1e-8 relative to the largest gradient
    x, y = _task()
    jm, jl, tm, tl, params, lik_params = _pair(kind)

    def f(p, x, y):
        m = jm.with_params({k[2:]: v for k, v in p.items() if k.startswith("m.")})
        lik = jl.with_params({k[2:]: v for k, v in p.items() if k.startswith("l.")})
        terms = gp.mlls.VariationalELBO(lik, m, num_data=N, combine_terms=False)(m(x), y)
        return terms[0] - terms[1] + terms[2], terms[1]

    p = {**{f"m.{k}": jnp.asarray(v) for k, v in params.items()},
         **{f"l.{k}": jnp.asarray(v) for k, v in lik_params.items()}}
    (jval, jkl), jgrad = jax.jit(jax.value_and_grad(f, has_aux=True))(p, jnp.asarray(x), jnp.asarray(y))
    log_lik, kl, log_prior = gt.mlls.VariationalELBO(tl, tm, num_data=N, combine_terms=False)(
        tm(torch.from_numpy(x)), torch.from_numpy(y))
    val = log_lik - kl + log_prior
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=RTOL)
    np.testing.assert_allclose(kl.item(), float(jkl), rtol=RTOL)
    tgrad = {**{f"m.{k}": q.grad.numpy() for k, q in tm.named_parameters()},
             **{f"l.{k}": q.grad.numpy() for k, q in tl.named_parameters()}}
    assert set(tgrad) == set(jgrad)
    if kind == "orthogonal":
        assert "m.variational_strategy.base_variational_strategy.inducing_points" in tgrad
    scale = max(np.abs(np.asarray(g)).max() for g in jgrad.values())
    for k, g in jgrad.items():
        np.testing.assert_allclose(tgrad[k], np.asarray(g), rtol=RTOL, atol=RTOL * scale, err_msg=k)


@pytest.mark.parametrize("kind", ["orthogonal", "batch"])
def test_predictions_match_jax(kind):
    # q(f) at 20 points in eval mode, mean and covariance, 1e-8 relative
    x, _ = _task()
    jm, _, tm, _, _, _ = _pair(kind)
    xs = x[:20]
    jm = jm.eval()
    jmean, jcov = jax.jit(lambda xs: (jm(xs).mean, jm(xs).covariance_matrix))(jnp.asarray(xs))
    tm.eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(xs))
    scale = np.abs(np.asarray(jcov)).max()
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(jmean), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(out.covariance_matrix.numpy(), np.asarray(jcov), rtol=RTOL, atol=RTOL * scale)


def test_orthogonal_kl_through_the_lazy_kernel_product():
    # with the mean inducing points' kernel kept lazy (max_eager_kernel_size(4): ½ mᵀ K m
    # goes through the streamed fused product, the plain version of kernel_matvec on the
    # CPU), the KL and its gradients equal the dense evaluation's, 1e-10 relative; the
    # wrapped strategy is a submodule once, and the model reference is not a submodule
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    _, _, tm, _, _, _ = _pair("orthogonal")
    strategy = tm.variational_strategy
    assert [name for name, _ in strategy.named_children()] == ["_variational_distribution",
                                                               "base_variational_strategy"]
    assert len(list(tm.parameters())) == len(set(map(id, tm.parameters())))
    kl_dense = strategy.kl_divergence(model=tm)
    grads_dense = torch.autograd.grad(kl_dense, list(tm.parameters()), allow_unused=True)
    calls, product = [], fk._product

    def counted(*args, **kwargs):
        calls.append(args[0].shape[0])
        return product(*args, **kwargs)

    fk._product = counted
    try:
        with gt.settings.max_eager_kernel_size(4):
            kl_lazy = strategy.kl_divergence(model=tm)
            grads_lazy = torch.autograd.grad(kl_lazy, list(tm.parameters()), allow_unused=True)
    finally:
        fk._product = product
    assert M_MEAN in calls
    np.testing.assert_allclose(kl_lazy.item(), kl_dense.item(), rtol=1e-10)
    for g_lazy, g_dense in zip(grads_lazy, grads_dense):
        if g_dense is not None:
            np.testing.assert_allclose(g_lazy.numpy(), g_dense.numpy(), rtol=1e-9, atol=1e-12)
