"""The port's multitask variational strategies against the JAX package, in float64 on the CPU.

``IndependentMultitaskVariationalStrategy`` (4 tasks, one whitened GP each) and
``LMCVariationalStrategy`` (3 latent GPs mixed into 4 tasks) over a batched whitened
``VariationalStrategy`` (Cholesky q(u), m = 12 inducing points a latent, ConstantMean and
ScaleKernel(RBFKernel(ard_num_dims=2)) with the latents' batch shape), on 64 points: through
``VariationalELBO`` with ``MultitaskGaussianLikelihood`` (4 task noises and the global
noise), and with ``task_indices`` (one task a point) through a ``GaussianLikelihood``.  The
ELBO and its gradient in every parameter against ``jax.grad``, and q(f)'s mean and
covariance.  The JAX model's parameters after its eager initialisation (its LMC coefficients
are ``PRNGKey(0)`` draws, another stream than the port's generator) are perturbed with numpy
and carried into the port by ``load_jax_params``.

Tolerance: 1e-8 relative (the same float64 arithmetic in another order, through the Cholesky
factors of K_ZZ + 1e-6·I).  Last, chip_smoke.py's stored LMC parity ELBO
(``tests/lmc_elbo_reference.py``) against the port on the CPU.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt

D, N, M, T, Q = 2, 64, 12, 4, 3
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
    f = np.stack([np.sin(3 * x[:, 0]), np.cos(2 * x[:, 1]), x[:, 0] * x[:, 1]], -1)
    y = f @ rng.normal(size=(3, T)) + 0.1 * rng.normal(size=(N, T))
    return x, y, rng.integers(0, T, size=N)


def _models(pkg, kind, Z):
    q = T if kind == "independent" else Q
    kw = {"dtype": F64} if pkg is gp else {}
    arr = jnp.asarray if pkg is gp else torch.from_numpy

    class MultitaskSVGP(pkg.models.ApproximateGP):
        def __init__(self):
            vd = pkg.variational.CholeskyVariationalDistribution(M, batch_shape=(q,), **kw)
            base = pkg.variational.VariationalStrategy(self, arr(Z), vd)
            if kind == "independent":
                strategy = pkg.variational.IndependentMultitaskVariationalStrategy(base, num_tasks=T)
            else:
                strategy = pkg.variational.LMCVariationalStrategy(base, num_tasks=T, num_latents=Q, latent_dim=-1)
            super().__init__(strategy)
            self.mean_module = pkg.means.ConstantMean(batch_shape=(q,), **kw)
            self.covar_module = pkg.kernels.ScaleKernel(pkg.kernels.RBFKernel(ard_num_dims=D, batch_shape=(q,), **kw),
                                                        batch_shape=(q,), **kw)

        def forward(self, x):
            return pkg.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    return MultitaskSVGP()


def _likelihoods(pkg, hadamard):
    kw = {"dtype": F64} if pkg is gp else {}
    if hadamard:
        return pkg.likelihoods.GaussianLikelihood(**kw)
    return pkg.likelihoods.MultitaskGaussianLikelihood(num_tasks=T, **kw)


def _perturbed(params, seed):
    """The JAX model's parameters with q(u) and the hyperparameters moved off their initial
    values: a lower-triangular factor with a positive diagonal, a random mean, and random
    raw hyperparameters, LMC coefficients and inducing points."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v, dtype=np.float64)
        if k.endswith("chol_variational_covar"):
            m = v.shape[-1]
            v = np.tril(0.3 * rng.normal(size=v.shape), -1) + np.eye(m) * rng.uniform(0.3, 1.0, size=v.shape[:-1] + (1,))
        elif k.endswith("inducing_points"):
            v = v + 0.05 * rng.normal(size=v.shape)
        else:
            v = v + 0.3 * rng.normal(size=v.shape)
        out[k] = v
    return out


def _pair(kind, hadamard=False, seed=0):
    x, _, _ = _task()
    q = T if kind == "independent" else Q
    rng = np.random.default_rng(seed)
    Z = np.stack([x[rng.choice(N, M, replace=False)] for _ in range(q)])
    jm, jl = _models(gp, kind, Z), _likelihoods(gp, hadamard)
    jm(jnp.asarray(x[:4]))  # eager initialisation, then overwritten
    params = _perturbed(jm.trainable_params(), seed + 1)
    lik_params = _perturbed(jl.trainable_params(), seed + 2)
    jm = jm.with_params({k: jnp.asarray(v) for k, v in params.items()})
    jl = jl.with_params({k: jnp.asarray(v) for k, v in lik_params.items()})
    tm, tl = _models(gt, kind, Z).double(), _likelihoods(gt, hadamard).double()
    gt.load_jax_params(tm, {**params, "variational_strategy.base_variational_strategy.variational_params_initialized": 1})
    gt.load_jax_params(tl, lik_params)
    return jm, jl, tm, tl, params, lik_params


@pytest.mark.parametrize("hadamard", [False, True], ids=["tasks", "task_indices"])
@pytest.mark.parametrize("kind", ["independent", "lmc"])
def test_elbo_and_gradients_match_jax(kind, hadamard):
    # the ELBO on the 64 points (all tasks, or one task a point) and its gradient in every
    # parameter (inducing points, q(u), LMC coefficients, kernel, mean, noises) against
    # jax.grad, 1e-8 relative to the largest gradient
    x, y, ti = _task()
    if hadamard:
        y = y[np.arange(N), ti]
    jm, jl, tm, tl, params, lik_params = _pair(kind, hadamard)
    kwargs = {"task_indices": jnp.asarray(ti)} if hadamard else {}

    def f(p, x, y):
        m = jm.with_params({k[2:]: v for k, v in p.items() if k.startswith("m.")})
        lik = jl.with_params({k[2:]: v for k, v in p.items() if k.startswith("l.")})
        return gp.mlls.VariationalELBO(lik, m, num_data=N)(m(x, **kwargs), y)

    p = {**{f"m.{k}": jnp.asarray(v) for k, v in params.items()},
         **{f"l.{k}": jnp.asarray(v) for k, v in lik_params.items()}}
    jval, jgrad = jax.jit(jax.value_and_grad(f))(p, jnp.asarray(x), jnp.asarray(y))
    tkw = {"task_indices": torch.from_numpy(ti)} if hadamard else {}
    val = gt.mlls.VariationalELBO(tl, tm, num_data=N)(tm(torch.from_numpy(x), **tkw), torch.from_numpy(y))
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=RTOL)
    tgrad = {**{f"m.{k}": q.grad.numpy() for k, q in tm.named_parameters()},
             **{f"l.{k}": q.grad.numpy() for k, q in tl.named_parameters()}}
    assert set(tgrad) == set(jgrad)
    scale = max(np.abs(np.asarray(g)).max() for g in jgrad.values())
    for k, g in jgrad.items():
        np.testing.assert_allclose(tgrad[k], np.asarray(g), rtol=RTOL, atol=RTOL * scale, err_msg=k)


@pytest.mark.parametrize("hadamard", [False, True], ids=["tasks", "task_indices"])
@pytest.mark.parametrize("kind", ["independent", "lmc"])
def test_predictions_match_jax(kind, hadamard):
    # q(f) at 24 points in eval mode: the (24, 4) task means and the interleaved 96 × 96
    # covariance (or, with task indices, 24 means and a 24 × 24 covariance), 1e-8 relative
    x, _, ti = _task()
    jm, _, tm, _, _, _ = _pair(kind, hadamard)
    xs, tis = x[:24], ti[:24]
    kwargs = {"task_indices": jnp.asarray(tis)} if hadamard else {}
    jm = jm.eval()
    jmean, jcov = jax.jit(lambda xs: (jm(xs, **kwargs).mean, jm(xs, **kwargs).covariance_matrix))(jnp.asarray(xs))
    tm.eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(xs), **({"task_indices": torch.from_numpy(tis)} if hadamard else {}))
    assert tuple(out.mean.shape) == ((24,) if hadamard else (24, T))
    scale = np.abs(np.asarray(jcov)).max()
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(jmean), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(out.covariance_matrix.numpy(), np.asarray(jcov), rtol=RTOL, atol=RTOL * scale)


def test_lmc_coefficients_draw_and_alias():
    # the coefficients are a float64 standard-normal draw of the generator given (seed 0 by
    # default), cast to the inducing points' dtype, of shape (latents, tasks);
    # MultitaskVariationalStrategy is the independent strategy
    Z = torch.zeros(Q, M, D)
    vd = gt.variational.CholeskyVariationalDistribution(M, batch_shape=(Q,))
    s = gt.variational.LMCVariationalStrategy(gt.variational.VariationalStrategy(None, Z, vd), num_tasks=T,
                                              num_latents=Q)
    want = torch.randn(Q, T, generator=torch.Generator().manual_seed(0), dtype=torch.float64).float()
    assert s.lmc_coefficients.dtype == torch.float32
    np.testing.assert_array_equal(s.lmc_coefficients.detach().numpy(), want.numpy())
    other = gt.variational.LMCVariationalStrategy(gt.variational.VariationalStrategy(None, Z, vd), num_tasks=T,
                                                  num_latents=Q, generator=torch.Generator().manual_seed(5))
    assert not torch.equal(other.lmc_coefficients, s.lmc_coefficients)
    assert gt.variational.MultitaskVariationalStrategy is gt.variational.IndependentMultitaskVariationalStrategy
    with pytest.raises(RuntimeError):
        gt.variational.LMCVariationalStrategy(gt.variational.VariationalStrategy(None, Z, vd), T, Q, latent_dim=0)


def test_chip_smoke_lmc_parity_constant():
    # chip_smoke.py's phase 17 gates the card's ELBO and KL term at its parity state against
    # the stored LMC_ELBO_JAX and LMC_KL_JAX: those constants are the JAX package's float64
    # values there (recomputed, 1e-12 relative), and the port on the CPU reads them within
    # the gates' tolerances in float64 and float32 (m = 256 inducing points a latent, a
    # minibatch of 512)
    import chip_smoke as cs
    from lmc_elbo_reference import jax_terms

    np.testing.assert_allclose(jax_terms(), (cs.LMC_ELBO_JAX, cs.LMC_KL_JAX), rtol=1e-12)
    for dtype, elbo_tol, kl_tol in zip((torch.float32, torch.float64), cs.LMC_ELBO_TOL, cs.LMC_KL_TOL):
        elbo, kl = cs.lmc_parity_terms("cpu", dtype)
        np.testing.assert_allclose(elbo, cs.LMC_ELBO_JAX, rtol=elbo_tol)
        np.testing.assert_allclose(kl, cs.LMC_KL_JAX, rtol=kl_tol)
