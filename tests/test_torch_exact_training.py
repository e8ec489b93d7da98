"""The port's exact-GP training slice against the JAX package, end to end.

The flagship model of bench.py (ConstantMean + ScaleKernel(RBFKernel(ard_num_dims=3)) +
GaussianLikelihood(GreaterThan(2e-2))) at N=700 train points (above
max_eager_kernel_size, so every product with K streams through the fused kernel product
and its backward), under bench.py's training settings with 8 probes and
min_preconditioning_size(0), so that the rank-50 preconditioner runs.  The same numpy
data, raw parameters and probe base samples go through both packages in float64: the
probes are injected into the JAX side by replacing gpytorch_tpu.linop.root's
probe_base_samples, and into the port through ``base_samples``.

Tolerance: 1e-8 relative.  Both packages run the same float64 arithmetic in another
order (CG, eigh, Cholesky), which puts their differences near 1e-12 for a short solve.
"""

import contextlib
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu.linop.root
import gpytorch_tpu_torch as gt
from gpytorch_tpu.models import ExactGP as JaxExactGP

N, D, PROBES = 700, 3, 8
NOISE_FLOOR = 2e-2
RTOL = 1e-8
PARAMS = {
    "covar_module.base_kernel.raw_lengthscale": np.array([[-0.4, 0.1, -0.7]]),
    "covar_module.raw_outputscale": np.array(0.5),
    "likelihood.noise_covar.raw_noise": np.array([-2.0]),
    "mean_module.raw_constant": np.array(0.05),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _task(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * np.sin(7 * x[:, 2] * x[:, 0]) + 0.1 * rng.normal(size=n)
    return x, (y - y.mean()) / y.std()


# the shapes of the probes' base samples with the rank-50 preconditioner: (t, k, 1), (t, n)
PROBE_SHAPES = ((PROBES, 50, 1), (PROBES, N))


class Probes:
    """Injected standard-normal base samples: the draw for a (step, shape) is fixed, so
    both packages see the same probes whatever order they ask in."""

    def __init__(self, step):
        self.step = step

    def __call__(self, shape):
        return np.random.default_rng([self.step, *shape]).normal(size=shape)

    def arrays(self):
        return {shape: jnp.asarray(self(shape)) for shape in PROBE_SHAPES}


def _exact_float64_sq_dist(x1, x2, x1_eq_x2=False):
    # gpytorch_tpu's sq_dist forms its distance product in float32 even under x64;
    # this is the same expansion in float64, so that both packages see one kernel matrix
    adj = jnp.mean(x1, axis=-2, keepdims=True)
    x1, x2 = x1 - adj, x2 - adj
    res = (
        -2.0 * jnp.matmul(x1, jnp.swapaxes(x2, -1, -2), precision=jax.lax.Precision.HIGHEST)
        + jnp.sum(x1 * x1, -1, keepdims=True)
        + jnp.swapaxes(jnp.sum(x2 * x2, -1, keepdims=True), -1, -2)
    )
    if x1_eq_x2:
        res = res * (1.0 - jnp.eye(res.shape[-1], dtype=res.dtype))
    return jnp.maximum(res, 0.0)


# the probe base samples of the JAX call being traced: an argument of the jitted loss
_JAX_DRAWS = {}


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    """JAX with float64 distances, and probes injected from the jitted loss's argument."""
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    monkeypatch.setattr(gpytorch_tpu.linop.root, "probe_base_samples",
                        lambda key, shape, dtype: _JAX_DRAWS["draws"][tuple(shape)].astype(dtype))


def _settings(mod, warm):
    stack = contextlib.ExitStack()
    for ctx in (
        mod.max_cholesky_size(0),
        mod.min_preconditioning_size(0),
        mod.max_cg_iterations(100),
        mod.cg_tolerance(0.3 if warm else 1.0),
        mod.num_trace_samples(PROBES),
        mod.max_lanczos_quadrature_iterations(6 if warm else 5),
        mod.max_preconditioner_size(50),
        mod.cg_stall_window(15 if warm else 5),
        mod.cg_lagged_rhs(warm),
        mod.precond_logdet_vr(warm),
        mod.preconditioner_noise_budget(1e-3),
        mod.fast_precond_grad(True),
    ):
        stack.enter_context(ctx)
    return stack


class JaxModel(JaxExactGP):
    def __init__(self, x, y, likelihood):
        super().__init__(x, y, likelihood)
        self.mean_module = gp.means.ConstantMean()
        self.covar_module = gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=D))

    def forward(self, x):
        return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


class TorchModel(gt.models.ExactGP):
    def __init__(self, x, y, likelihood):
        super().__init__(x, y, likelihood)
        self.mean_module = gt.means.ConstantMean()
        self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D))

    def forward(self, x):
        return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


def _torch_model():
    x, y = _task(N)
    tm = TorchModel(torch.from_numpy(x), torch.from_numpy(y),
                    gt.likelihoods.GaussianLikelihood(noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR))).double()
    return gt.load_jax_params(tm, PARAMS)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(warm):
    """jit(value_and_grad) of the negative MLL over the raw parameters, as a function of
    (params, warm state, probe base samples)."""
    x, y = (jnp.asarray(a) for a in _task(N))
    jm = JaxModel(x, y, gp.likelihoods.GaussianLikelihood(noise_constraint=gp.constraints.GreaterThan(NOISE_FLOOR)))

    def loss(p, st, draws):
        _JAX_DRAWS["draws"] = draws
        m = jm.with_params(p)
        with _settings(gp.settings, warm):
            mll = gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)
            if warm:
                val, new_st = mll(m(x), y, key=jax.random.PRNGKey(0), solver_state=st, return_state=True)
                return -val, new_st
            return -mll(m(x), y, key=jax.random.PRNGKey(0)), st

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _torch_loss(tm, probes, warm, state):
    tm.train()
    tx, ty = tm.train_inputs[0], tm.train_targets
    with _settings(gt.settings, warm):
        mll = gt.mlls.ExactMarginalLogLikelihood(tm.likelihood, tm)
        if warm:
            val, state = mll(tm(tx), ty, base_samples=probes, solver_state=state, return_state=True)
        else:
            val = mll(tm(tx), ty, base_samples=probes)
    loss = -val
    tm.zero_grad()
    loss.backward()
    return loss, {k: p.grad.clone() for k, p in tm.named_parameters()}, state


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "rhs_warm_lagged_vr"])
def test_mll_value_and_gradients_match_jax_package(warm):
    tm = _torch_model()
    st0 = jnp.zeros((N, 1)) if warm else None
    (jloss, _), jgrad = _jax_value_and_grad(warm)({k: jnp.asarray(v) for k, v in PARAMS.items()}, st0, Probes(0).arrays())
    tloss, tgrad, _ = _torch_loss(tm, Probes(0), warm, torch.zeros(N, 1, dtype=torch.float64) if warm else None)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL)
    assert set(tgrad) == set(jgrad)
    for name, g in tgrad.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[name]), rtol=RTOL, atol=RTOL * np.abs(jgrad[name]).max(),
                                   err_msg=name)


def test_three_cosine_adam_steps_match_jax_package():
    # bench.py's optimiser: Adam with cosine decay 0.1 → 0.01 over 120 steps, carrying the
    # rhs-only warm state from step to step, with fresh probes each step
    tm = _torch_model()
    vg = _jax_value_and_grad(True)
    opt = optax.adam(optax.cosine_decay_schedule(0.1, 120, alpha=0.1))
    params = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    opt_state, jst = opt.init(params), jnp.zeros((N, 1))

    topt = torch.optim.Adam(tm.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(topt, T_max=120, eta_min=0.01)
    tst = torch.zeros(N, 1, dtype=torch.float64)
    names = [k for k, _ in tm.named_parameters()]
    for step in range(3):
        (jloss, jst), grads = vg(params, jst, Probes(step).arrays())
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)

        tloss, _, tst = _torch_loss(tm, Probes(step), True, tst)
        topt.step()
        sched.step()
        assert tst.num_iters >= 6
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=RTOL)
        raw = dict(tm.named_parameters())
        for name in names:
            np.testing.assert_allclose(raw[name].detach().numpy(), np.asarray(params[name]), rtol=RTOL, atol=RTOL,
                                       err_msg=f"step {step}: {name}")


def test_constrained_setters_match_bench_initialisation():
    # bench.py sets noise 0.1 and lengthscale 0.5 through the constrained setters; the raw
    # values are softplus⁻¹ of the value above the constraint's floor
    tm = _torch_model()
    tm.likelihood.noise = 0.1
    tm.covar_module.base_kernel.lengthscale = 0.5
    tm.initialize(**{"covar_module.outputscale": 2.0})
    np.testing.assert_allclose(tm.likelihood.noise_covar.raw_noise.detach().numpy(), [np.log(np.expm1(0.1 - NOISE_FLOOR))],
                               rtol=1e-12)
    np.testing.assert_allclose(tm.covar_module.base_kernel.raw_lengthscale.detach().numpy(),
                               np.full((1, D), np.log(np.expm1(0.5))), rtol=1e-12)
    np.testing.assert_allclose(tm.likelihood.noise.item(), 0.1, rtol=1e-12)
    np.testing.assert_allclose(tm.covar_module.outputscale.item(), 2.0, rtol=1e-12)
    with pytest.raises(ValueError):
        tm.likelihood.noise = 0.01  # below the GreaterThan(2e-2) floor
