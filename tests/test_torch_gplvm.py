"""The port's Bayesian GPLVM (``models/gplvm.py``) against the JAX package, in float64 on the
CPU, at ``tests/test_gplvm.py``'s sizes: 48 points of 6 observed dimensions from a 2-d latent
(numpy draws of that test's lift), one GP per observed dimension in a batch (12 inducing
points, Cholesky q(u), jitter 1e-4, ConstantMean and ScaleKernel(RBF-ARD) of batch shape (6,)),
and ``VariationalELBO(num_data=48)``.

Parity: the ELBO with its added loss term and its gradient in every parameter, for the point,
MAP and variational latents, on all points and on a minibatch of the latent draw.  The JAX
package draws the variational latent's ε as ``jax.random.normal(key, (n, latent_dim))``; the
port takes that ε (``eps=``).  The JAX model's parameters after its eager initialisation are
moved with numpy and carried into the port by ``load_jax_params``.

The latent KL term is subtracted from each of the data_dim batch elements' ELBO.  The port's
is Σ KL(q(x) ‖ p(x)) / (n · data_dim), GPyTorch's, so a loss summed over the elements counts
the KL once per point; the JAX package's is Σ KL / n (data_dim / (n · data_dim)), which counts
it data_dim times.  The parity of a variational latent's ELBO is held to the JAX value less
(data_dim − 1) of its terms, and a test pins both factors.  At the shape of GPyTorch's GPLVM
tutorial (1,000 points, 12 observed and 12 latent dimensions), training with the JAX factor
drew q(X) towards the prior and the latent geometry away from the truth (chip_smoke's phase
19c).

Tolerance: 1e-10 relative (the same float64 arithmetic in another order).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt

N, DATA_DIM, LATENT_DIM, M = 48, 6, 2, 12
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


def _make_data(seed=0):
    """``examples/10_gplvm_latent_space.py::make_data``'s lift of a 2-d latent, drawn with numpy."""
    rng = np.random.default_rng(seed)
    X_true = rng.normal(size=(N, LATENT_DIM))
    lin = X_true @ (0.6 * rng.normal(size=(LATENT_DIM, DATA_DIM)))
    return X_true, lin + 0.4 * np.sin(2.0 * lin) + 0.05 * rng.normal(size=(N, DATA_DIM))


def _pca_init(Y, k):
    Yc = Y - Y.mean(0)
    X0 = Yc @ np.linalg.svd(Yc, full_matrices=False)[2][:k].T
    return X0 / X0.std(0, keepdims=True)


def _latent(pkg, kind, X_init):
    arr = jnp.asarray if pkg is gp else torch.from_numpy
    if kind == "point":
        return pkg.models.PointLatentVariable(N, LATENT_DIM, arr(X_init))
    if kind == "map":
        return pkg.models.MAPLatentVariable(N, LATENT_DIM, arr(X_init), pkg.priors.NormalPrior(np.float64(0.0),
                                                                                               np.float64(1.0)))
    prior_x = pkg.priors.NormalPrior(arr(np.zeros((N, LATENT_DIM))), arr(np.ones((N, LATENT_DIM))))
    return pkg.models.VariationalLatentVariable(N, DATA_DIM, LATENT_DIM, arr(X_init), prior_x)


def _gplvm(pkg, latent, Z):
    kw = {"dtype": F64} if pkg is gp else {}
    arr = jnp.asarray if pkg is gp else torch.from_numpy

    class GPLVM(pkg.models.BayesianGPLVM):
        def __init__(self):
            vd = pkg.variational.CholeskyVariationalDistribution(M, batch_shape=(DATA_DIM,), **kw)
            strategy = pkg.variational.VariationalStrategy(self, arr(Z), vd, learn_inducing_locations=True,
                                                           jitter_val=1e-4)
            super().__init__(latent, strategy)
            self.mean_module = pkg.means.ConstantMean(batch_shape=(DATA_DIM,), **kw)
            self.covar_module = pkg.kernels.ScaleKernel(
                pkg.kernels.RBFKernel(ard_num_dims=LATENT_DIM, batch_shape=(DATA_DIM,), **kw),
                batch_shape=(DATA_DIM,), **kw)

        def forward(self, x):
            return pkg.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    return GPLVM()


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v, dtype=np.float64)
        if k.endswith("chol_variational_covar"):
            v = np.tril(0.2 * rng.normal(size=v.shape), -1) + np.eye(M) * rng.uniform(0.3, 1.0, size=v.shape[:-1] + (1,))
        elif k.endswith("inducing_points") or k.startswith("X."):
            v = v + 0.05 * rng.normal(size=v.shape)
        else:
            v = v + 0.3 * rng.normal(size=v.shape)
        out[k] = v
    return out


def _pair(kind, seed=0):
    X_true, Y = _make_data()
    X_init = _pca_init(Y, LATENT_DIM)
    Z = np.random.default_rng(3).normal(size=(DATA_DIM, M, LATENT_DIM))
    jm = _gplvm(gp, _latent(gp, kind, X_init), Z)
    jl = gp.likelihoods.GaussianLikelihood(batch_shape=(DATA_DIM,), dtype=F64)
    jm(jm.sample_latent_variable(jax.random.PRNGKey(0)))  # eager initialisation, then overwritten
    params = _perturbed(jm.trainable_params(), seed + 1)
    lik_params = _perturbed(jl.trainable_params(), seed + 2)
    tm = _gplvm(gt, _latent(gt, kind, X_init), Z).double()
    tl = gt.likelihoods.GaussianLikelihood(batch_shape=(DATA_DIM,)).double()
    gt.load_jax_params(tm, {**params, "variational_strategy.variational_params_initialized": 1})
    gt.load_jax_params(tl, lik_params)
    return jm, jl, tm, tl, params, lik_params, Y


@pytest.mark.parametrize("minibatch", [False, True], ids=["all", "minibatch"])
@pytest.mark.parametrize("kind", ["point", "map", "variational"])
def test_elbo_and_gradients_match_jax(kind, minibatch):
    jm, jl, tm, tl, params, lik_params, Y = _pair(kind)
    idx = np.sort(np.random.default_rng(5).choice(N, 16, replace=False)) if minibatch else np.arange(N)
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, (N, LATENT_DIM), dtype=F64))

    @jax.jit
    def loss(p, lp):
        # the JAX loss with (data_dim − 1) of its data_dim latent KL terms taken back out
        m, lik = jm.with_params(p), jl.with_params(lp)
        x = m.sample_latent_variable(key)[idx]
        value = -jnp.sum(gp.mlls.VariationalELBO(lik, m, num_data=N)(m(x), jnp.asarray(Y[idx].T)))
        return value - (DATA_DIM - 1) * sum(term.loss() for term in m.added_loss_terms())

    jval, (jgrad, jlgrad) = jax.value_and_grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, {k: jnp.asarray(v) for k, v in lik_params.items()})
    x = tm.sample_latent_variable(eps=torch.from_numpy(eps))[torch.from_numpy(idx)]
    value = -gt.mlls.VariationalELBO(tl, tm, num_data=N)(tm(x), torch.from_numpy(Y[idx].T)).sum()
    value.backward()
    np.testing.assert_allclose(value.item(), float(jval), rtol=RTOL)
    grads = {**{k: (p.grad, jgrad[k]) for k, p in tm.named_parameters()},
             **{f"likelihood.{k}": (p.grad, jlgrad[k]) for k, p in tl.named_parameters()}}
    assert {k for k, _ in tm.named_parameters()} == set(params)
    for name, (got, want) in grads.items():
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max(), err_msg=name)


def test_latent_variables():
    X_init = _pca_init(_make_data()[1], LATENT_DIM)
    point, var = _latent(gt, "point", X_init), _latent(gt, "variational", X_init)
    assert point() is point.X and [k for k, _ in point.named_parameters()] == ["X"]
    m = _latent(gt, "map", X_init)
    assert [name for name, *_ in m.named_priors()] == ["prior_x"]
    torch.testing.assert_close(m.prior_log_prob_sum(),
                               torch.distributions.Normal(0.0, 1.0).log_prob(m.X).sum())
    assert sorted(k for k, _ in var.named_parameters()) == ["q_log_sigma", "q_mu"]
    # prior_x's hyperparameters are buffers, not parameters, and load by name
    assert sorted(k for k, _ in var.named_buffers()) == ["prior_x.loc", "prior_x.scale"]
    # a draw from a generator is reproducible, and eps= gives q_mu + softplus(q_log_sigma)·ε
    a = var(generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, var(generator=torch.Generator().manual_seed(1)), rtol=0, atol=0)
    eps = torch.randn(N, LATENT_DIM, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    torch.testing.assert_close(a, var.q_mu + torch.nn.functional.softplus(var.q_log_sigma) * eps)


def test_latent_kl_counts_once_per_point_and_pins_the_jax_factor():
    jm, jl, tm, tl, params, lik_params, Y = _pair("variational")
    x = tm.sample_latent_variable(generator=torch.Generator().manual_seed(0))
    terms = gt.mlls.VariationalELBO(tl, tm, num_data=N, combine_terms=False)(tm(x), torch.from_numpy(Y.T))
    added = terms[3]
    q = torch.distributions.Normal(tm.X.q_mu, torch.nn.functional.softplus(tm.X.q_log_sigma))
    p = torch.distributions.Normal(torch.zeros(N, LATENT_DIM, dtype=torch.float64), 1.0)
    kl = torch.distributions.kl_divergence(q, p).sum()
    # Σ KL / (n · data_dim) in each batch element: summed over them, Σ KL / n, once per point
    torch.testing.assert_close(added, (kl / (N * DATA_DIM)).expand(DATA_DIM), rtol=1e-12, atol=0)
    torch.testing.assert_close(added.sum(), kl / N, rtol=1e-12, atol=0)
    # the JAX package's term is data_dim times the port's: Σ KL / n in each element
    jterm = gp.mlls.added_loss_term.KLGaussianAddedLossTerm(
        gp.distributions.Normal(jnp.asarray(tm.X.q_mu.detach().numpy()),
                                jax.nn.softplus(jnp.asarray(tm.X.q_log_sigma.detach().numpy()))),
        gp.priors.NormalPrior(jnp.zeros((N, LATENT_DIM)), jnp.ones((N, LATENT_DIM))), N, DATA_DIM)
    np.testing.assert_allclose(float(jterm.loss()), DATA_DIM * added[0].item(), rtol=1e-12)
    combined = gt.mlls.VariationalELBO(tl, tm, num_data=N)(tm(x), torch.from_numpy(Y.T))
    torch.testing.assert_close(combined, terms[0] - terms[1] + terms[2] - added, rtol=1e-12, atol=0)
    assert combined.shape == (DATA_DIM,)


def test_training_recovers_the_latent_geometry():
    # tests/test_gplvm.py's run: 300 Adam steps at 0.05 on all points, the distance-matrix
    # correlation of q_mu with the true latents above 0.5
    X_true, Y = _make_data()
    Z = np.random.default_rng(3).normal(size=(DATA_DIM, M, LATENT_DIM))
    model = _gplvm(gt, _latent(gt, "variational", _pca_init(Y, LATENT_DIM)), Z).double()
    likelihood = gt.likelihoods.GaussianLikelihood(batch_shape=(DATA_DIM,)).double()
    mll = gt.mlls.VariationalELBO(likelihood, model, num_data=N)
    optimizer = torch.optim.Adam([*model.parameters(), *likelihood.parameters()], lr=0.05)
    generator, target = torch.Generator().manual_seed(10), torch.from_numpy(Y.T)
    losses = []
    for _ in range(300):
        optimizer.zero_grad()
        loss = -mll(model(model.sample_latent_variable(generator)), target).sum()
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all() and np.mean(losses[-20:]) < losses[0]
    mu = model.X.q_mu.detach().numpy()
    dA = np.linalg.norm(mu[:, None] - mu[None], axis=-1).ravel()
    dB = np.linalg.norm(X_true[:, None] - X_true[None], axis=-1).ravel()
    corr = np.corrcoef(dA, dB)[0, 1]
    assert corr > 0.5, corr
