"""The port's periodic exact GP against the JAX package, end to end: training objective,
gradients, three Adam steps and serving.

ConstantMean + ScaleKernel(PeriodicKernel(ard_num_dims=2)) + GaussianLikelihood(GreaterThan(2e-2))
on chip_smoke.py's seasonal task (5-minute readings, x = [t, t], periods of 1 and 7 days),
at N=700 train points (above max_eager_kernel_size, so every product with K streams through
the fused periodic product and its backward).  The kernel there is numerically low rank
(at lengthscale 0.5 about 95 of its 700 eigenvalues lie above 1e-12 of the largest; at
1.5 the rank-50 preconditioner's last pivots fall to the 1e-9 level), the regime the
N=100k model trains in.  The same numpy data, raw parameters (carried by
load_jax_params), probe base samples and Lanczos start block go through both packages in
float64; the JAX side is jitted.

Tolerances: 1e-8 relative for the MLL, its gradients and the Adam steps, 1e-9 for the
posterior mean and variance — float64 round-off of the same arithmetic in another order.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu.linop.root
import gpytorch_tpu.solvers.lanczos
import gpytorch_tpu_torch as gt
from gpytorch_tpu_torch.ops import periodic_kernels as ppk
from chip_smoke import P_PERIOD_LR as PERIOD_LR
from chip_smoke import make_periodic_task
from gpytorch_tpu.models import ExactGP as JaxExactGP

N, M, D, PROBES = 700, 60, 2, 8
NOISE_FLOOR = 2e-2


def _raw(value, floor=0.0):
    return np.log(np.expm1(np.asarray(value, dtype=np.float64) - floor))


def _params(lengthscale):
    # chip_smoke.py's initial values: noise 0.1, periods [1, 7] days, the lengthscale given
    return {
        "covar_module.base_kernel.raw_lengthscale": _raw([[lengthscale, lengthscale]]),
        "covar_module.base_kernel.raw_period_length": _raw([[1.0, 7.0]]),
        "covar_module.raw_outputscale": np.array(0.0),
        "likelihood.noise_covar.raw_noise": _raw([0.1], NOISE_FLOOR),
        "mean_module.raw_constant": np.array(0.0),
    }


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _task():
    train_x, train_y, test_x, test_y = make_periodic_task(N, M)
    return train_x, train_y, test_x, test_y, np.random.default_rng(5).normal(size=(N, 20))


PROBE_SHAPES = ((PROBES, 50, 1), (PROBES, N))


class Probes:
    """Injected standard-normal base samples, fixed per (step, shape)."""

    def __init__(self, step):
        self.step = step

    def __call__(self, shape):
        return np.random.default_rng([self.step, *shape]).normal(size=shape)

    def arrays(self):
        return {shape: jnp.asarray(self(shape)) for shape in PROBE_SHAPES}


_JAX_DRAWS = {}


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    monkeypatch.setattr(gpytorch_tpu.linop.root, "probe_base_samples",
                        lambda key, shape, dtype: _JAX_DRAWS["draws"][tuple(shape)].astype(dtype))
    monkeypatch.setattr(gpytorch_tpu.solvers.lanczos, "_block_init", lambda linop, iv, b: jnp.asarray(_task()[4]))


def _train_settings(mod):
    # chip_smoke.py's (bench.py's) training recipe, with 8 probes
    stack = contextlib.ExitStack()
    for ctx in (
        mod.max_cholesky_size(0),
        mod.min_preconditioning_size(0),
        mod.max_cg_iterations(100),
        mod.cg_tolerance(0.3),
        mod.num_trace_samples(PROBES),
        mod.max_lanczos_quadrature_iterations(6),
        mod.max_preconditioner_size(50),
        mod.cg_stall_window(15),
        mod.cg_lagged_rhs(True),
        mod.precond_logdet_vr(True),
        mod.preconditioner_noise_budget(1e-3),
        mod.fast_precond_grad(True),
    ):
        stack.enter_context(ctx)
    return stack


def _serving_settings(mod):
    stack = contextlib.ExitStack()
    for ctx in (
        mod.max_cholesky_size(0),
        mod.min_preconditioning_size(0),
        mod.max_preconditioner_size(50),
        mod.preconditioner_noise_budget(1e-3),
        mod.eval_cg_tolerance(1e-3),
        mod.cg_stall_window(50),
        mod.max_root_decomposition_size(100),
        mod.fast_pred_var(True),
    ):
        stack.enter_context(ctx)
    return stack


class JaxModel(JaxExactGP):
    def __init__(self, x, y, likelihood):
        super().__init__(x, y, likelihood)
        self.mean_module = gp.means.ConstantMean()
        self.covar_module = gp.kernels.ScaleKernel(gp.kernels.PeriodicKernel(ard_num_dims=D))

    def forward(self, x):
        return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


class TorchModel(gt.models.ExactGP):
    def __init__(self, x, y, likelihood, **kwargs):
        super().__init__(x, y, likelihood, **kwargs)
        self.mean_module = gt.means.ConstantMean()
        self.covar_module = gt.kernels.ScaleKernel(gt.kernels.PeriodicKernel(ard_num_dims=D))

    def forward(self, x):
        return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


def _jax_model():
    x, y = (jnp.asarray(a) for a in _task()[:2])
    return JaxModel(x, y, gp.likelihoods.GaussianLikelihood(noise_constraint=gp.constraints.GreaterThan(NOISE_FLOOR)))


def _torch_model(params):
    x, y = (torch.from_numpy(a) for a in _task()[:2])
    tm = TorchModel(x, y, gt.likelihoods.GaussianLikelihood(noise_constraint=gt.constraints.GreaterThan(NOISE_FLOOR)),
                    lanczos_init=torch.from_numpy(_task()[4])).double()
    return gt.load_jax_params(tm, params)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    """jit(value_and_grad) of the negative MLL (rhs-warm, lagged, variance-reduced) over
    the raw parameters, as a function of (params, warm state, probe base samples)."""
    jm = _jax_model()

    def loss(p, st, draws):
        _JAX_DRAWS["draws"] = draws
        m = jm.with_params(p)
        with _train_settings(gp.settings):
            mll = gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)
            val, new_st = mll(m(m.train_inputs[0]), m.train_targets, key=jax.random.PRNGKey(0), solver_state=st,
                              return_state=True)
        return -val, new_st

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _torch_loss(tm, probes, state):
    tm.train()
    with _train_settings(gt.settings):
        mll = gt.mlls.ExactMarginalLogLikelihood(tm.likelihood, tm)
        val, state = mll(tm(tm.train_inputs[0]), tm.train_targets, base_samples=probes, solver_state=state,
                         return_state=True)
    loss = -val
    tm.zero_grad()
    loss.backward()
    return loss, {k: p.grad.clone() for k, p in tm.named_parameters()}, state


@pytest.mark.parametrize("lengthscale", [0.5, 1.5])
def test_mll_value_and_gradients_match_jax_package(lengthscale, monkeypatch):
    params = _params(lengthscale)
    (jloss, _), jgrad = _jax_value_and_grad()({k: jnp.asarray(v) for k, v in params.items()}, jnp.zeros((N, 1)),
                                              Probes(0).arrays())
    # the port's path: one periodic product per CG iteration, one fused backward
    calls = {"product": 0, "backward": 0}
    for name, key in (("_periodic_product", "product"), ("_periodic_bwd_fused", "backward")):
        fn = getattr(ppk, name)
        monkeypatch.setattr(ppk, name, lambda *a, _fn=fn, _k=key: calls.__setitem__(_k, calls[_k] + 1) or _fn(*a))
    tloss, tgrad, tst = _torch_loss(_torch_model(params), Probes(0), torch.zeros(N, 1, dtype=torch.float64))
    assert tst.num_iters >= 6
    assert calls == {"product": tst.num_iters, "backward": 1}
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-8)
    assert set(tgrad) == set(jgrad) and "covar_module.base_kernel.raw_period_length" in tgrad
    for name, g in tgrad.items():
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[name]), rtol=1e-8, atol=1e-8 * np.abs(jgrad[name]).max(),
                                   err_msg=name)


def _cosine(step, steps=120):
    # optax.cosine_decay_schedule(lr, steps, alpha=0.1) as a factor of lr
    return 0.1 + 0.9 * 0.5 * (1.0 + np.cos(np.pi * min(step, steps) / steps))


def test_three_adam_steps_match_jax_package():
    # chip_smoke.py's periodic recipe: cosine Adam 0.1 → 0.01, the periods at their own
    # learning rate, the rhs-only warm state carried from step to step, fresh probes
    params0 = _params(0.5)
    tm = _torch_model(params0)
    period = "covar_module.base_kernel.raw_period_length"
    vg = _jax_value_and_grad()
    labels = {k: "period" if k == period else "main" for k in params0}
    opt = optax.multi_transform({"main": optax.adam(optax.cosine_decay_schedule(0.1, 120, alpha=0.1)),
                                 "period": optax.adam(optax.cosine_decay_schedule(PERIOD_LR, 120, alpha=0.1))}, labels)
    params = {k: jnp.asarray(v) for k, v in params0.items()}
    opt_state, jst = opt.init(params), jnp.zeros((N, 1))

    @jax.jit
    def adam_step(p, st, grads):
        updates, st = opt.update(grads, st)
        return optax.apply_updates(p, updates), st

    named = dict(tm.named_parameters())
    topt = torch.optim.Adam([{"params": [p for k, p in named.items() if k != period], "lr": 0.1},
                             {"params": [named[period]], "lr": PERIOD_LR}])
    sched = torch.optim.lr_scheduler.LambdaLR(topt, _cosine)
    tst = torch.zeros(N, 1, dtype=torch.float64)
    for step in range(3):
        (jloss, jst), grads = vg(params, jst, Probes(step).arrays())
        params, opt_state = adam_step(params, opt_state, grads)

        tloss, _, tst = _torch_loss(tm, Probes(step), tst)
        topt.step()
        sched.step()
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-8)
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[name]), rtol=1e-8, atol=1e-8,
                                       err_msg=f"step {step}: {name}")
    # the periods moved, by about their own learning rate
    moved = np.abs(named[period].detach().numpy() - params0[period])
    assert (moved > 0).all() and (moved < 10 * PERIOD_LR).all()


def test_serving_matches_jax_package():
    params = _params(0.5)
    _, _, test_x, _, _ = _task()

    @jax.jit
    def jax_serve(p, tx):
        m = _jax_model().with_params(p).eval()
        with _serving_settings(gp.settings):
            pred = m.likelihood(m(tx))
            return pred.mean, pred.variance

    jmean, jvar = jax_serve({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(test_x))
    tm = _torch_model(params).eval()
    with _serving_settings(gt.settings), torch.no_grad():
        pred = tm.likelihood(tm(torch.from_numpy(test_x)))
        tmean, tvar = pred.mean.numpy(), pred.variance.numpy()
    assert np.isfinite(tvar).all() and (tvar > 0).all()
    np.testing.assert_allclose(tmean, np.asarray(jmean), rtol=1e-9, atol=1e-9 * np.abs(np.asarray(jmean)).max())
    np.testing.assert_allclose(tvar, np.asarray(jvar), rtol=1e-9, atol=1e-12)


def test_load_jax_params_carries_the_period_unchanged():
    params = _params(0.5)
    params["covar_module.base_kernel.raw_period_length"] = np.array([[0.3, 6.9]])
    jm = _jax_model().with_params({k: jnp.asarray(v) for k, v in params.items()})
    tm = _torch_model(params)
    kern = tm.covar_module.base_kernel
    np.testing.assert_array_equal(kern.raw_period_length.detach().numpy(), params["covar_module.base_kernel.raw_period_length"])
    np.testing.assert_allclose(kern.period_length.detach().numpy(), np.asarray(jm.covar_module.base_kernel.period_length),
                               rtol=1e-12)
    # the kernel itself, dense, against the JAX package's on the same points
    x = _task()[0][:40] + np.random.default_rng(3).uniform(size=(40, D))
    want = np.asarray(jm.covar_module(jnp.asarray(x)).to_dense())
    got = tm.covar_module(torch.from_numpy(x)).to_dense().detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tm.covar_module(torch.from_numpy(x), diag=True).detach().numpy(), np.diag(want), rtol=1e-12)
