"""The port's VNNGP (``NNVariationalStrategy``) and nearest-neighbour search against the JAX
package, in float64 on the CPU.

``NNUtil``'s queries and sequential structure must give the JAX package's indices exactly
(no ties in continuous data).  ``IVFNNUtil`` is approximate and seeds its k-means from an
explicit ``torch.Generator`` (the JAX package from a PRNG key), so the two packages' indices
differ: its recall against the exact search is held to the JAX test's own threshold, 0.95,
on the JAX test's data (3,000 Gaussian points, k = 8, 128 queries), and its sequential
structure to the same recall.  The VNNGP ELBO (ConstantMean, ScaleKernel(Matérn-5/2 ARD),
GaussianLikelihood; M = 120 inducing points that are the training inputs, k = 6) is taken
with the minibatch's ``indices`` and the stochastic KL's ``kl_indices`` passed explicitly to
both packages, at the same state (``load_jax_params`` carries q(u), the initialised flag and
the JAX package's ``nn_xinduce_idx``), and differentiated; also the full KL and the
predictions.  The JAX side gets exact float64 distances and is ``jax.jit``ted.

Tolerance: 1e-10 relative (the same float64 solves of k × k systems in another order).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt
from gpytorch_tpu.utils.nearest_neighbors import NNUtil as JaxNNUtil
from gpytorch_tpu_torch.utils.nearest_neighbors import IVFNNUtil, NNUtil

D, M, K = 3, 120, 6
RTOL = 1e-10
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


def test_nn_util_indices_match_jax_exactly():
    # the 5 nearest of 400 points to 60 queries, and the sequential structure (the 5 nearest
    # preceding points of each), index for index
    rng = np.random.default_rng(0)
    x, q = rng.uniform(size=(400, D)), rng.uniform(size=(60, D))
    j_util, t_util = JaxNNUtil(5, D), NNUtil(5, D)
    j_util.set_nn_idx(jnp.asarray(x))
    t_util.set_nn_idx(torch.from_numpy(x))
    np.testing.assert_array_equal(t_util.find_nn_idx(torch.from_numpy(q)).numpy(), np.asarray(j_util.find_nn_idx(q)))
    np.testing.assert_array_equal(t_util.build_sequential_nn_idx(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_util.build_sequential_nn_idx(x)))


def _recall(exact, approx):
    k = exact.shape[-1]
    return np.mean([len(set(e) & set(a)) / k for e, a in zip(exact.tolist(), approx.tolist())])


def test_ivf_recall_against_exact():
    # the JAX test's data: recall ≥ 0.95 of the queries' 8 nearest, indices in range, a
    # training point its own nearest (≥ 0.95 of 16), the single-query path; the sequential
    # structure's recall ≥ 0.95 against the exact one; a generator seeded alike repeats
    # the index bit for bit
    rng = np.random.RandomState(0)
    n, k = 3000, 8
    x = torch.from_numpy(rng.randn(n, D).astype(np.float32))
    q = torch.from_numpy(rng.randn(128, D).astype(np.float32))
    exact, ivf = NNUtil(k, D), IVFNNUtil(k, D, nprobe=8, generator=torch.Generator().manual_seed(3))
    exact.set_nn_idx(x)
    ivf.set_nn_idx(x)
    got = ivf.find_nn_idx(q)
    assert got.shape == (128, k) and got.min() >= 0 and got.max() < n
    assert _recall(exact.find_nn_idx(q).numpy(), got.numpy()) >= 0.95
    assert (ivf.find_nn_idx(x[:16])[:, 0].numpy() == np.arange(16)).mean() >= 0.95
    assert ivf.find_nn_idx(q[0], k=4).shape == (4,)
    seq_exact, seq_ivf = exact.build_sequential_nn_idx(x), ivf.build_sequential_nn_idx(x)
    assert seq_ivf.shape == (n - k, k)
    assert bool((seq_ivf < torch.arange(k, n).unsqueeze(-1)).all())  # only preceding points
    assert _recall(seq_exact.numpy(), seq_ivf.numpy()) >= 0.95
    again = IVFNNUtil(k, D, nprobe=8, generator=torch.Generator().manual_seed(3))
    again.set_nn_idx(x)
    np.testing.assert_array_equal(again.find_nn_idx(q).numpy(), got.numpy())


# -- the VNNGP strategy ------------------------------------------------------------------------

def _task(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(M, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * x[:, 2] + 0.1 * rng.normal(size=M)
    return x, y


def _pair():
    x, y = _task()
    rng = np.random.default_rng(2)
    name = "variational_strategy._variational_distribution."
    params = {"covar_module.raw_outputscale": np.asarray(0.3),
              "covar_module.base_kernel.raw_lengthscale": rng.uniform(-1.2, -0.6, size=(1, D)),
              "mean_module.raw_constant": np.asarray(0.1),
              name + "variational_mean": rng.normal(size=M), name + "raw_variational_stddev": rng.uniform(0.05, 0.4, M)}

    class JaxVNNGP(gp.models.ApproximateGP):
        def __init__(self):
            vd = gp.variational.MeanFieldVariationalDistribution(M, dtype=F64)
            super().__init__(gp.variational.NNVariationalStrategy(self, jnp.asarray(x), vd, k=K))
            self.mean_module = gp.means.ConstantMean(dtype=F64)
            self.covar_module = gp.kernels.ScaleKernel(gp.kernels.MaternKernel(nu=2.5, ard_num_dims=D, dtype=F64),
                                                       dtype=F64)

        def forward(self, xx):
            return gp.distributions.MultivariateNormal(self.mean_module(xx), self.covar_module(xx))

    class TorchVNNGP(gt.models.ApproximateGP):
        def __init__(self):
            vd = gt.variational.MeanFieldVariationalDistribution(M)
            super().__init__(gt.variational.NNVariationalStrategy(self, torch.from_numpy(x), vd, k=K))
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.MaternKernel(nu=2.5, ard_num_dims=D))

        def forward(self, xx):
            return gt.distributions.MultivariateNormal(self.mean_module(xx), self.covar_module(xx))

    jm = JaxVNNGP()
    jm(jnp.asarray(x[:4]))  # eager initialisation, then overwritten
    jm = jm.with_params({k: jnp.asarray(v) for k, v in params.items()})
    tm = TorchVNNGP().double()
    gt.load_jax_params(tm, {**params, "variational_strategy.variational_params_initialized": 1,
                            "variational_strategy.nn_xinduce_idx": np.asarray(jm.variational_strategy.nn_xinduce_idx)})
    jl = gp.likelihoods.GaussianLikelihood(dtype=F64).with_params({"noise_covar.raw_noise": jnp.asarray([-2.5])})
    tl = gt.likelihoods.GaussianLikelihood().double()
    gt.load_jax_params(tl, {"noise_covar.raw_noise": np.array([-2.5])})
    return jm, jl, tm, tl, params, x, y


def test_vnngp_elbo_and_gradients_match_jax():
    # the ELBO of a minibatch of 32 (``indices``) with the stochastic KL over 40 points
    # (``kl_indices``), and its gradient with respect to q(u) and the hyperparameters,
    # against jax.value_and_grad, 1e-10 relative; the strategy's sequential structure is
    # the JAX package's own
    jm, jl, tm, tl, params, x, y = _pair()
    assert tm.variational_strategy.nn_xinduce_idx.shape == (M - K, K)
    rng = np.random.default_rng(4)
    idx = rng.choice(M, 32, replace=False)
    kl_idx = rng.choice(np.arange(K, M), 40, replace=False)

    def jax_elbo(p):
        m = jm.with_params(p)
        out = m(jnp.asarray(x[idx]), indices=jnp.asarray(idx))
        return gp.mlls.VariationalELBO(jl, m, num_data=M)(out, jnp.asarray(y[idx]), kl_indices=jnp.asarray(kl_idx))

    jval, jgrad = jax.jit(jax.value_and_grad(jax_elbo))({k: jnp.asarray(v) for k, v in params.items()})
    out = tm(torch.from_numpy(x[idx]), indices=torch.from_numpy(idx))
    elbo = gt.mlls.VariationalELBO(tl, tm, num_data=M)(out, torch.from_numpy(y[idx]),
                                                       kl_indices=torch.from_numpy(kl_idx))
    elbo.backward()
    np.testing.assert_allclose(elbo.item(), float(jval), rtol=RTOL)
    own = dict(tm.named_parameters())
    for name, g in jgrad.items():
        g = np.asarray(g)
        np.testing.assert_allclose(own[name].grad.numpy(), g, rtol=1e-9, atol=1e-9 * max(np.abs(g).max(), 1e-30),
                                   err_msg=name)


def test_vnngp_full_kl_and_predictions_match_jax():
    # the full KL over all M points (and the stochastic estimator with every j ≥ k, which
    # is the same sum), and eval-mode predictions of 30 new points (mean and variance,
    # each conditioned on its 6 nearest inducing points), 1e-10 relative
    jm, _, tm, _, _, _, _ = _pair()
    j_kl = jax.jit(lambda: jm.variational_strategy.kl_divergence(model=jm))()
    with torch.no_grad():
        t_kl = tm.variational_strategy.kl_divergence(model=tm)
        t_all = tm.variational_strategy.kl_divergence(model=tm, kl_indices=torch.arange(K, M))
    np.testing.assert_allclose([t_kl.item(), t_all.item()], [float(j_kl)] * 2, rtol=RTOL)
    xs = np.random.default_rng(6).uniform(size=(30, D))
    jm.eval()
    jout = jax.jit(lambda xx: (jm(xx).mean, jm(xx).variance))(jnp.asarray(xs))
    tm.eval()
    with torch.no_grad():
        tout = tm(torch.from_numpy(xs))
    np.testing.assert_allclose(tout.mean.numpy(), np.asarray(jout[0]), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(tout.variance.numpy(), np.asarray(jout[1]), rtol=RTOL, atol=RTOL)


def test_vnngp_training_call_without_indices_and_errors():
    # without indices the full set (or, for other inputs, each input's nearest inducing
    # point); a Cholesky q(u), k ≥ M and an unknown index library are refused
    _, _, tm, _, _, x, _ = _pair()
    vd = tm.variational_strategy._variational_distribution
    with torch.no_grad():
        full = tm(torch.from_numpy(x))
        moved = tm(torch.from_numpy(x[:7] + 1e-4))
    np.testing.assert_allclose(full.mean.numpy(), vd.variational_mean.detach().numpy())
    np.testing.assert_allclose(moved.mean.numpy(), vd.variational_mean.detach().numpy()[:7])
    Z = torch.from_numpy(x)
    with pytest.raises(RuntimeError):
        gt.variational.NNVariationalStrategy(None, Z, gt.variational.CholeskyVariationalDistribution(M), k=K)
    with pytest.raises(ValueError):
        gt.variational.NNVariationalStrategy(None, Z, gt.variational.MeanFieldVariationalDistribution(M), k=M)
    with pytest.raises(ValueError):
        gt.variational.NNVariationalStrategy(None, Z, gt.variational.MeanFieldVariationalDistribution(M), k=K,
                                             preferred_nnlib="faiss")
