"""The port's model lists (``IndependentModelList``, ``LikelihoodList``) and
``SumMarginalLogLikelihood`` against the JAX package, in float64 on the CPU.

Two outcomes of the same inputs (d=3): one exact GP with ScaleKernel(RBF-ARD), one with
ScaleKernel(Matérn-5/2 ARD), each with ConstantMean and a GaussianLikelihood with a
LogNormal(−4, 1) noise prior.  The same numpy data and raw parameters go through both
packages; the JAX package's float32 distance product is swapped for a float64 one.  The
summed MLL and its gradient on the dense-Cholesky branch (n = 300) and by preconditioned mBCG
(n = 1,000, under max_cholesky_size(0)), with probe base samples injected into both packages
by shape and occurrence (the two models draw equal shapes, one after the other).  The JAX
package's exact MLL counts each likelihood's prior twice (``test_torch_priors.py``); inside
the sum it does so once per model, so the port equals the JAX value less each model's
likelihood prior term over its n.

Tolerances: 1e-9 relative on the Cholesky branch, 1e-8 on mBCG (as ``test_torch_priors.py``),
1e-10 for predictions and fantasies from dense factors.
"""

import collections
import contextlib
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu.linop.base
import gpytorch_tpu.linop.root
import gpytorch_tpu_torch as gt
import gpytorch_tpu_torch.linop.base
import gpytorch_tpu_torch.linop.root

D, PROBES, N_CHOL, N_MBCG = 3, 8, 300, 1000
PARAMS = [
    {"covar_module.base_kernel.raw_lengthscale": np.array([[-0.4, 0.1, -0.7]]),
     "covar_module.raw_outputscale": np.array(0.5),
     "likelihood.noise_covar.raw_noise": np.array([-3.0]),
     "mean_module.raw_constant": np.array(0.05)},
    {"covar_module.base_kernel.raw_lengthscale": np.array([[-0.2, -0.6, 0.3]]),
     "covar_module.raw_outputscale": np.array(-0.1),
     "likelihood.noise_covar.raw_noise": np.array([-2.5]),
     "mean_module.raw_constant": np.array(-0.1)},
]
LIST_PARAMS = {f"models.{i}.{k}": v for i, p in enumerate(PARAMS) for k, v in p.items()}


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


class _Probes:
    """Base samples keyed by their shape and the how-manieth draw of that shape since the
    last ``reset``: the same sequence for both packages."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.count = collections.Counter()

    def __call__(self, shape):
        shape = tuple(int(s) for s in shape)
        self.count[shape] += 1
        return np.random.default_rng([9, self.count[shape], *shape]).normal(size=shape)


PROBE_SOURCE = _Probes()


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    jax_draw = lambda key, shape, dtype: jnp.asarray(PROBE_SOURCE(shape), dtype=dtype)  # noqa: E731
    torch_draw = lambda shape, dtype, device, source=None: torch.as_tensor(  # noqa: E731
        PROBE_SOURCE(shape), dtype=dtype, device=device)
    for module, draw in ((gpytorch_tpu.linop.base, jax_draw), (gpytorch_tpu.linop.root, jax_draw),
                         (gpytorch_tpu_torch.linop.base, torch_draw), (gpytorch_tpu_torch.linop.root, torch_draw)):
        monkeypatch.setattr(module, "probe_base_samples", draw)


def _task(n, seed=0):
    """The flagship's function and a second outcome, cos(5x₀ + 2x₁)·exp(−x₂), each with noise
    0.1, standardised."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * np.sin(7 * x[:, 2] * x[:, 0]) + 0.1 * rng.normal(size=n)
    c = np.cos(5 * x[:, 0] + 2 * x[:, 1]) * np.exp(-x[:, 2]) + 0.1 * rng.normal(size=n)
    return x, (y - y.mean()) / y.std(), (c - c.mean()) / c.std()


def _model(pkg, x, y, kind):
    base = (pkg.kernels.RBFKernel(ard_num_dims=D) if kind == 0
            else pkg.kernels.MaternKernel(nu=2.5, ard_num_dims=D))
    likelihood = pkg.likelihoods.GaussianLikelihood(noise_prior=pkg.priors.LogNormalPrior(np.float64(-4.0),
                                                                                          np.float64(1.0)))

    class Outcome(pkg.models.ExactGP):
        def __init__(self):
            super().__init__(x, y, likelihood)
            self.mean_module = pkg.means.ConstantMean()
            self.covar_module = pkg.kernels.ScaleKernel(base)

        def forward(self, inputs):
            return pkg.distributions.MultivariateNormal(self.mean_module(inputs), self.covar_module(inputs))

    return Outcome()


def _lists(n):
    x, y, c = _task(n)
    jl = gp.models.IndependentModelList(*[_model(gp, jnp.asarray(x), jnp.asarray(t), i) for i, t in enumerate((y, c))])
    jl = jl.with_params({k: jnp.asarray(v) for k, v in LIST_PARAMS.items()})
    tl = gt.models.IndependentModelList(*[_model(gt, torch.from_numpy(x), torch.from_numpy(t), i)
                                          for i, t in enumerate((y, c))]).double()
    return jl, gt.load_jax_params(tl, LIST_PARAMS), (x, y, c)


def _settings(mod, mbcg):
    stack = contextlib.ExitStack()
    if mbcg:
        for ctx in (mod.max_cholesky_size(0), mod.min_preconditioning_size(0), mod.max_cg_iterations(200),
                    mod.cg_tolerance(1e-3), mod.num_trace_samples(PROBES), mod.max_lanczos_quadrature_iterations(5),
                    mod.max_preconditioner_size(50), mod.preconditioner_noise_budget(1e-3)):
            stack.enter_context(ctx)
    return stack


@functools.lru_cache(maxsize=None)
def _jax_sum_mll(n, mbcg):
    """jit(value_and_grad) of the JAX package's summed MLL over the list's raw parameters,
    and of Σᵢ (likelihood i's prior term) / n."""
    jl, _, (x, y, c) = _lists(n)
    x, targets = jnp.asarray(x), [jnp.asarray(y), jnp.asarray(c)]

    def mll(p):
        m = jl.with_params(p)
        with _settings(gp.settings, mbcg):
            return gp.mlls.SumMarginalLogLikelihood(m.likelihood, m)(m(x, x), targets)

    def lik_priors(p):
        m = jl.with_params(p)
        return sum(mi.likelihood.prior_log_prob_sum() for mi in m.models) / n

    return jax.jit(jax.value_and_grad(mll)), jax.jit(jax.value_and_grad(lik_priors))


@pytest.mark.parametrize("n,mbcg,rtol", [(N_CHOL, False, 1e-9), (N_MBCG, True, 1e-8)], ids=["cholesky", "mbcg"])
def test_sum_mll_and_gradient_match_jax(n, mbcg, rtol):
    params = {k: jnp.asarray(v) for k, v in LIST_PARAMS.items()}
    mll_vg, prior_vg = _jax_sum_mll(n, mbcg)
    PROBE_SOURCE.reset()
    jval, jgrad = mll_vg(params)
    jprior, jprior_grad = prior_vg(params)
    _, tl, (x, y, c) = _lists(n)
    PROBE_SOURCE.reset()
    with _settings(gt.settings, mbcg):
        mll = gt.mlls.SumMarginalLogLikelihood(tl.likelihood, tl)
        value = mll(tl(torch.from_numpy(x), torch.from_numpy(x)), [torch.from_numpy(y), torch.from_numpy(c)])
    value.backward()
    np.testing.assert_allclose(value.item(), float(jval) - float(jprior), rtol=rtol)
    tgrad = {k: p.grad.numpy() for k, p in tl.named_parameters()}
    assert set(tgrad) == set(jgrad) == set(LIST_PARAMS)
    for name, g in tgrad.items():
        want = np.asarray(jgrad[name]) - np.asarray(jprior_grad[name])
        np.testing.assert_allclose(g, want, rtol=rtol, atol=rtol * np.abs(want).max(), err_msg=name)
    assert abs(float(jprior)) > 1e-3  # one copy per model is large enough to tell


def test_sum_mll_is_the_sum_of_the_models_mlls():
    # the same probes, drawn model by model: the sum equals each model's own MLL added
    _, tl, (x, y, c) = _lists(N_MBCG)
    tx = torch.from_numpy(x)
    with _settings(gt.settings, True):
        PROBE_SOURCE.reset()
        total = gt.mlls.SumMarginalLogLikelihood(tl.likelihood, tl)(tl(tx, tx), [torch.from_numpy(y),
                                                                                 torch.from_numpy(c)])
        PROBE_SOURCE.reset()
        parts = [gt.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(tx), torch.from_numpy(t))
                 for m, t in zip(tl.models, (y, c))]
    assert total.item() == parts[0].item() + parts[1].item()


def test_likelihood_list_and_predictions_match_jax():
    jl, tl, (x, y, c) = _lists(N_CHOL)
    xs = np.random.default_rng(1).uniform(size=(40, D))
    tl.eval()

    @jax.jit
    def predict(p, xs):
        m = jl.with_params(p).eval()
        return [(o.mean, o.variance) for o in m.likelihood(*m(xs, xs))]

    jpred = predict({k: jnp.asarray(v) for k, v in LIST_PARAMS.items()}, jnp.asarray(xs))
    with torch.no_grad():
        outputs = tl(torch.from_numpy(xs), (torch.from_numpy(xs),))
        tpred = tl.likelihood(*outputs)
        listed = tl.likelihood(outputs)  # one list, as the JAX package also takes
    assert isinstance(tl.likelihood, gt.likelihoods.LikelihoodList) and len(tpred) == 2
    for (j_mean, j_var), t, u in zip(jpred, tpred, listed):
        np.testing.assert_allclose(t.mean.numpy(), np.asarray(j_mean), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(t.variance.numpy(), np.asarray(j_var), rtol=1e-10)
        torch.testing.assert_close(u.mean, t.mean, rtol=0, atol=0)
    with torch.no_grad():
        # forward_i and likelihood_i reach model i alone
        prior1 = tl.forward_i(1, torch.from_numpy(xs))
        torch.testing.assert_close(prior1.mean, tl.models[1].forward(torch.from_numpy(xs)).mean)
        marginal = tl.likelihood_i(0, outputs[0])
        torch.testing.assert_close(marginal.variance, tpred[0].variance)


def test_get_fantasy_model_matches_jax():
    jl, tl, (x, y, c) = _lists(N_CHOL)
    rng = np.random.default_rng(2)
    xf = [rng.uniform(size=(6, D)) for _ in range(2)]
    yf = [rng.normal(size=6) for _ in range(2)]
    xs = rng.uniform(size=(30, D))
    tl.eval()

    @jax.jit
    def fantasy_predict(p, xf, yf, xs):
        m = jl.with_params(p).eval()
        m(xs, xs)  # the old strategies, which the fantasies update
        return [(o.mean, o.variance) for o in m.get_fantasy_model(xf, yf)(xs, xs)]

    with torch.no_grad():
        tl(torch.from_numpy(xs), torch.from_numpy(xs))
        tf = tl.get_fantasy_model([torch.from_numpy(a) for a in xf], [torch.from_numpy(a) for a in yf])
        tpred = tf(torch.from_numpy(xs), torch.from_numpy(xs))
    jpred = fantasy_predict({k: jnp.asarray(v) for k, v in LIST_PARAMS.items()}, [jnp.asarray(a) for a in xf],
                            [jnp.asarray(a) for a in yf], jnp.asarray(xs))
    assert isinstance(tf, gt.models.IndependentModelList) and len(tf.models) == 2
    for i, ((j_mean, j_var), t) in enumerate(zip(jpred, tpred)):
        assert tf.models[i].train_targets.shape[-1] == N_CHOL + 6
        np.testing.assert_allclose(t.mean.numpy(), np.asarray(j_mean), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(t.variance.numpy(), np.asarray(j_var), rtol=1e-10, atol=1e-14)


def test_parameters_once_and_modes_reach_every_model():
    _, tl, _ = _lists(50)
    mll = gt.mlls.SumMarginalLogLikelihood(tl.likelihood, tl)
    per_model = [p for m in tl.models for p in m.parameters()]
    for module in (tl, mll):
        params = list(module.parameters())
        assert len(params) == len(per_model) == 8 and {id(p) for p in params} == {id(p) for p in per_model}
    tl.eval()
    assert not any(m.training for m in tl.modules())
    tl.train()
    assert all(m.training for m in tl.modules())
    with pytest.raises(ValueError, match="likelihood"):
        gt.models.IndependentModelList(tl.models[0], gt.means.ConstantMean())


def test_load_jax_params_takes_model_list_names():
    jl, tl, _ = _lists(50)
    params = {k: np.asarray(v) for k, v in jl.trainable_params().items()}
    assert set(params) == set(LIST_PARAMS)
    for name, p in tl.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[name])
    with pytest.raises(KeyError, match="missing"):
        gt.load_jax_params(tl, {k: v for k, v in params.items() if not k.startswith("models.1.")})
