"""The port's two-layer deep GP against the JAX package, in float64 on the CPU.

A hidden layer of H independent GPs (LinearMean, ScaleKernel(RBFKernel(ard_num_dims=3)),
whitened q(u) of m = 8 inducing points each) on a 3-input task, and an output layer (ConstantMean,
ScaleKernel(RBFKernel(ard_num_dims=H))) with a GaussianLikelihood, trained by
``DeepApproximateMLL(VariationalELBO)``.  The same numpy parameters go into both packages (the
port's through ``load_jax_params`` with the strategies' ``variational_params_initialized``
flags).  The JAX side gets float64 distances and is ``jax.jit``ted.

The two packages draw their samples from different random streams, so the cases either feed
both the same base samples through the root of the hidden layer's covariance
(``rsample_from_base_samples`` on the JAX side), with the Lanczos start blocks injected into
both by shape where the root is a Lanczos one, or feed both output layers the same hidden
samples with ``are_samples=True``.

Tolerances are stated at each test: 1e-8 relative where both packages run the same float64
arithmetic in another order.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu.solvers.lanczos
import gpytorch_tpu_torch as gt
import gpytorch_tpu_torch.solvers.lanczos

D, H, M, N, S = 3, 3, 8, 40, 3
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
    """Float64 distances in JAX; Lanczos start blocks injected into both packages by shape."""
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    monkeypatch.setattr(gpytorch_tpu.solvers.lanczos, "_block_init",
                        lambda linop, iv, b: jnp.asarray(_draw(9, linop.batch_shape + (linop.shape[-1], b))))
    monkeypatch.setattr(gpytorch_tpu_torch.solvers.lanczos, "_block_init",
                        lambda linop, iv, b: torch.from_numpy(_draw(9, linop.batch_shape + (linop.shape[-1], b))))


def _task(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * x[:, 2] + 0.1 * rng.normal(size=n)
    return x, y


def _deep_gp(pkg, hidden_dims):
    kw = {"dtype": F64} if pkg is gp else {}

    class Layer(pkg.models.deep_gps.DeepGPLayer):
        def __init__(self, input_dims, output_dims):
            batch = () if output_dims is None else (output_dims,)
            vd = pkg.variational.CholeskyVariationalDistribution(M, batch_shape=batch, **kw)
            Z = np.zeros(batch + (M, input_dims))  # replaced by the loaded parameters
            Z = jnp.asarray(Z) if pkg is gp else torch.from_numpy(Z)
            super().__init__(pkg.variational.VariationalStrategy(self, Z, vd), input_dims, output_dims)
            self.mean_module = (pkg.means.LinearMean(input_dims, batch_shape=batch, **kw) if output_dims
                                else pkg.means.ConstantMean(**kw))
            self.covar_module = pkg.kernels.ScaleKernel(
                pkg.kernels.RBFKernel(ard_num_dims=input_dims, batch_shape=batch, **kw), batch_shape=batch, **kw)

        def forward(self, x):
            return pkg.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    class TwoLayerDeepGP(pkg.models.deep_gps.DeepGP):
        def __init__(self):
            super().__init__()
            self.hidden_layer = Layer(D, hidden_dims)
            self.last_layer = Layer(hidden_dims, None)
            self.likelihood = pkg.likelihoods.GaussianLikelihood(**kw)

        def forward(self, x, samples=None):
            if samples is None:
                return self.last_layer(self.hidden_layer(x))
            return self.last_layer(samples, are_samples=True)

    model = TwoLayerDeepGP()
    return model if pkg is gp else model.double()


def _value(name, shape, rng):
    if name.endswith("chol_variational_covar"):
        m = shape[-1]
        return np.tril(0.2 * rng.normal(size=shape), -1) + np.eye(m) * rng.uniform(0.3, 1.0, size=shape[:-1])[..., None, :]
    if name.endswith("inducing_points"):
        return rng.uniform(size=shape) if "hidden" in name else rng.normal(size=shape)
    if name.endswith("raw_noise"):
        return np.full(shape, -2.0)
    if name.endswith("raw_lengthscale"):
        return rng.uniform(-0.6, 0.4, size=shape)
    return 0.5 * rng.normal(size=shape)


def _pair(hidden_dims=H, seed=4):
    """The JAX deep GP and the port's at the same numpy parameters, every q(u) initialised."""
    x, _ = _task()
    jm = _deep_gp(gp, hidden_dims)
    with gp.settings.num_likelihood_samples(1):
        jm(jnp.asarray(x[:4]))  # eager initialisation, then overwritten
    rng = np.random.default_rng(seed)
    params = {k: _value(k, np.shape(v), rng) for k, v in sorted(jm.trainable_params().items())}
    jm = jm.with_params({k: jnp.asarray(v) for k, v in params.items()})
    tm = _deep_gp(gt, hidden_dims)
    flags = {f"{layer}.variational_strategy.variational_params_initialized": 1 for layer in ("hidden_layer", "last_layer")}
    gt.load_jax_params(tm, {**params, **flags})
    return jm, tm, params


def test_hidden_layer_output_matches_jax():
    # the hidden layer's task-major q(f) over (n, H), repeated over S samples: its mean and its
    # block-diagonal covariance, 1e-8 relative, and the KL of both layers
    x, _ = _task()
    jm, tm, _ = _pair()

    @jax.jit
    def jax_side(xs):
        with gp.settings.num_likelihood_samples(S):
            out = jm.hidden_layer(xs)
        return out.mean, out.covariance_matrix, jm.deep_kl_divergence()

    jmean, jcov, jkl = jax_side(jnp.asarray(x))
    with torch.no_grad(), gt.settings.num_likelihood_samples(S):
        out = tm.hidden_layer(torch.from_numpy(x))
        tkl = tm.deep_kl_divergence()
    assert isinstance(out, gt.distributions.MultitaskMultivariateNormal) and not out.interleaved
    assert tuple(out.batch_shape) == (S,) and tuple(out.mean.shape) == (S, N, H)
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(jmean), rtol=RTOL, atol=RTOL)
    scale = np.abs(np.asarray(jcov)).max()
    np.testing.assert_allclose(out.covariance_matrix.numpy(), np.asarray(jcov), rtol=RTOL, atol=RTOL * scale)
    np.testing.assert_allclose(tkl.item(), float(jkl), rtol=RTOL)


@pytest.mark.parametrize("n,hidden_dims", [(N, H), (100, 9)], ids=["cholesky", "lanczos"])
def test_joint_sample_matches_jax(n, hidden_dims):
    # one joint draw of all n·H hidden values per sample from the same base samples: through
    # the Cholesky root of the whole block-diagonal covariance at n·H = 120, and through a
    # rank-100 Lanczos root (start blocks injected) at n·H = 900 > max_cholesky_size.  The
    # roots against the JAX package's, each column up to its sign (eigh fixes no sign, and
    # LAPACK's choice differs between the two packages), then the port's draw against the
    # JAX package's rsample_from_base_samples on the sign-aligned base samples; 1e-8 relative
    # to the largest value
    x = np.random.default_rng(1).uniform(size=(n, D))
    jm, tm, _ = _pair(hidden_dims)

    with torch.no_grad(), gt.settings.num_likelihood_samples(2):
        hidden = tm.hidden_layer(torch.from_numpy(x))
        root = hidden.lazy_covariance_matrix.root_decomposition().root.numpy()
        draws = hidden.rsample(base_samples=lambda shape: _draw(5, shape))
    k = n * hidden_dims if n * hidden_dims <= 800 else 100
    assert tuple(draws.shape) == (2, n, hidden_dims) and root.shape == (2, n * hidden_dims, k)
    eps = _draw(5, (1, 2, k, 1))[0, ..., 0]

    @jax.jit
    def jax_side(xs, eps):
        with gp.settings.num_likelihood_samples(2):
            out = jm.hidden_layer(xs)
        flat = gp.distributions.MultivariateNormal(out.loc, out.lazy_covariance_matrix)
        root = out.lazy_covariance_matrix.root_decomposition().root
        return out._flat_to_task(flat.rsample_from_base_samples(eps)), root.to_dense() if hasattr(root, "to_dense") else root

    jroot = np.asarray(jax_side(jnp.asarray(x), jnp.asarray(eps))[1])
    align = np.sign(np.einsum("bik,bik->bk", root, jroot))
    np.testing.assert_allclose(root * align[:, None, :], jroot, rtol=RTOL, atol=RTOL * np.abs(jroot).max())
    want = np.asarray(jax_side(jnp.asarray(x), jnp.asarray(eps * align))[0])
    np.testing.assert_allclose(draws.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_deep_objective_and_gradients_match_jax():
    # DeepApproximateMLL(VariationalELBO) on the same hidden samples (are_samples=True) and its
    # gradient in every parameter of both layers and the likelihood (the hidden layer's through
    # its KL term) against jax.grad, 1e-8 relative to the largest gradient
    x, y = _task()
    jm, tm, params = _pair()
    samples = 0.5 * _draw(3, (S, N, H))

    def f(p):
        m = jm.with_params(p)
        mll = gp.mlls.DeepApproximateMLL(gp.mlls.VariationalELBO(m.likelihood, m, num_data=4 * N))
        return mll(m(jnp.asarray(x), jnp.asarray(samples)), jnp.asarray(y))

    jval, jgrad = jax.jit(jax.value_and_grad(f))({k: jnp.asarray(v) for k, v in params.items()})
    mll = gt.mlls.DeepApproximateMLL(gt.mlls.VariationalELBO(tm.likelihood, tm, num_data=4 * N))
    val = mll(tm(torch.from_numpy(x), torch.from_numpy(samples)), torch.from_numpy(y))
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=RTOL)
    # the whitened KL does not reach the hidden layer's kernel, mean and inducing points:
    # autograd leaves them without a gradient where jax.grad gives zeros
    tgrad = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in tm.named_parameters()}
    assert set(tgrad) == set(jgrad)
    scale = max(np.abs(np.asarray(g)).max() for g in jgrad.values())
    for k, g in jgrad.items():
        np.testing.assert_allclose(tgrad[k].numpy(), np.asarray(g), rtol=RTOL, atol=RTOL * scale, err_msg=k)
    with pytest.raises(ValueError):
        gt.mlls.DeepApproximateMLL(gt.mlls.VariationalELBO(tm.likelihood, tm, num_data=N, combine_terms=False))


def test_sampled_objective_reaches_every_parameter():
    # the objective through the joint sample of the hidden layer (base samples from a seeded
    # generator): finite, repeatable from the same generator state, and with a finite,
    # nonzero gradient in every parameter (the hidden layer's through the sample's root)
    x, y = _task()
    _, tm, _ = _pair()
    mll = gt.mlls.DeepApproximateMLL(gt.mlls.VariationalELBO(tm.likelihood, tm, num_data=N))
    values = []
    for _ in range(2):
        tm.zero_grad()
        gen = torch.Generator().manual_seed(2)
        with gt.settings.num_likelihood_samples(S):
            hidden = tm.hidden_layer(torch.from_numpy(x))
            val = mll(tm.last_layer(hidden, base_samples=gen), torch.from_numpy(y))
        val.backward()
        values.append(val.item())
    assert np.isfinite(values[0]) and values[0] == values[1]
    for k, p in tm.named_parameters():
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, k
