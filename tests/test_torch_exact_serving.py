"""The port's exact-GP serving slice against the JAX package, end to end.

The flagship model of bench.py (ConstantMean + ScaleKernel(RBFKernel(ard_num_dims=3)) +
GaussianLikelihood) at N=700 train points (above max_eager_kernel_size, so K(train, train)
and K(test, train) stream through the fused matvec), under the serving settings
(max_cholesky_size(0), min_preconditioning_size(0), fast_pred_var).  The same numpy data,
the same raw parameters (carried by load_jax_params) and the same Lanczos start block go
through both packages in float64.
"""

import contextlib
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu.solvers.lanczos
import gpytorch_tpu_torch as gt
from gpytorch_tpu.models import ExactGP as JaxExactGP

N, M, D = 700, 400, 3
PARAMS = {
    "covar_module.base_kernel.raw_lengthscale": np.array([[-1.0, -0.5, -1.2]]),
    "covar_module.raw_outputscale": np.array(0.3),
    "likelihood.noise_covar.raw_noise": np.array([-3.5]),
    "mean_module.raw_constant": np.array(0.05),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _task(n, m, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n + m, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * np.sin(7 * x[:, 2] * x[:, 0]) + 0.1 * rng.normal(size=n + m)
    y = (y - y.mean()) / y.std()
    return x[:n], y[:n], x[n:], y[n:], rng.normal(size=(n, 20))


class JaxModel(JaxExactGP):
    def __init__(self, x, y, likelihood):
        super().__init__(x, y, likelihood)
        self.mean_module = gp.means.ConstantMean()
        self.covar_module = gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=D))

    def forward(self, x):
        return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


class TorchModel(gt.models.ExactGP):
    def __init__(self, x, y, likelihood, **kwargs):
        super().__init__(x, y, likelihood, **kwargs)
        self.mean_module = gt.means.ConstantMean()
        self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D))

    def forward(self, x):
        return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


def _serving_settings(mod, fast_pred_var):
    stack = contextlib.ExitStack()
    for ctx in (
        mod.max_cholesky_size(0),
        mod.min_preconditioning_size(0),
        mod.max_preconditioner_size(50),
        mod.preconditioner_noise_budget(1e-3),
        mod.eval_cg_tolerance(1e-3),
        mod.cg_stall_window(50),
        mod.max_root_decomposition_size(100),
        mod.fast_pred_var(fast_pred_var),
    ):
        stack.enter_context(ctx)
    return stack


def _exact_float64_sq_dist(x1, x2, x1_eq_x2=False):
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


@functools.lru_cache(maxsize=None)
def _served(fast_pred_var, m):
    """Serve the same task through both packages; the predictive mean, variance, RMSE and
    joint NLPD (eigenvalues floored at the likelihood noise) of each, as numpy."""
    train_x, train_y, test_x, test_y, block = _task(N, m)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # Lanczos start block into the JAX side (the port takes it as lanczos_init)
        mp.setattr(gpytorch_tpu.solvers.lanczos, "_block_init", lambda linop, iv, b: jnp.asarray(block))
        # gpytorch_tpu's sq_dist forms its distance product with preferred_element_type=float32
        # even under x64, a 1e-7 relative perturbation of every kernel entry.  Swap in the same
        # expansion in float64 so that both packages evaluate the same kernel matrix and the
        # comparison can hold them to float64 round-off.
        mp.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
        mp.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)


        # jitted: eager JAX compiles op by op, which took most of this test's time
        @jax.jit
        def jax_serve(params, tx, ty):
            jm = JaxModel(jnp.asarray(train_x), jnp.asarray(train_y), gp.likelihoods.GaussianLikelihood())
            jm = jm.with_params(params).eval()
            with _serving_settings(gp.settings, fast_pred_var):
                jpred = jm.likelihood(jm(tx))
                return (jpred.mean, jpred.variance, gp.metrics.mean_squared_error(jpred, ty, squared=False),
                        gp.metrics.negative_log_predictive_density(jpred, ty, eig_floor=jm.likelihood.noise),
                        jpred.covariance_matrix)

        mean, var, rmse, nlpd, cov = jax_serve({k: jnp.asarray(v) for k, v in PARAMS.items()}, jnp.asarray(test_x),
                                               jnp.asarray(test_y))
        out["jax"] = dict(mean=np.asarray(mean), var=np.asarray(var), rmse=float(rmse), nlpd=float(nlpd),
                          cov=np.asarray(cov))

    tm = TorchModel(torch.from_numpy(train_x), torch.from_numpy(train_y), gt.likelihoods.GaussianLikelihood(),
                    lanczos_init=torch.from_numpy(block)).double()
    gt.load_jax_params(tm, PARAMS)
    tm.eval()
    with _serving_settings(gt.settings, fast_pred_var), torch.no_grad():
        tpred = tm.likelihood(tm(torch.from_numpy(test_x)))
        ty = torch.from_numpy(test_y)
        out["torch"] = dict(
            mean=tpred.mean.numpy(), var=tpred.variance.numpy(),
            rmse=gt.metrics.mean_squared_error(tpred, ty, squared=False).item(),
            nlpd=gt.metrics.negative_log_predictive_density(tpred, ty, eig_floor=tm.likelihood.noise).item(),
            cov=tpred.covariance_matrix.numpy(),
        )
    out["cg_iters"] = tm.prediction_strategy().lik_train_train_covar.last_cg_result.num_iters
    return out


@pytest.mark.parametrize("fast_pred_var,m", [(True, M), (False, 40)])
def test_serving_matches_jax_package(fast_pred_var, m):
    served = _served(fast_pred_var, m)
    j, t = served["jax"], served["torch"]
    assert np.isfinite(t["var"]).all() and (t["var"] > 0).all()
    np.testing.assert_allclose(t["mean"], j["mean"], rtol=1e-9, atol=1e-9 * np.abs(j["mean"]).max())
    np.testing.assert_allclose(t["var"], j["var"], rtol=1e-9, atol=1e-12)
    assert served["cg_iters"] > 0


@pytest.mark.parametrize("fast_pred_var,m", [(True, M), (False, 40)])
def test_metrics_match_jax_package(fast_pred_var, m):
    # gpytorch_tpu_torch.metrics against gpytorch_tpu.metrics on the same predictive
    # distributions: RMSE, and the joint NLPD from the dense covariance whose
    # eigenvalues are floored at the likelihood noise
    j, t = _served(fast_pred_var, m)["jax"], _served(fast_pred_var, m)["torch"]
    assert np.isfinite([t["rmse"], t["nlpd"]]).all()
    np.testing.assert_allclose(t["rmse"], j["rmse"], rtol=1e-9)
    np.testing.assert_allclose(t["nlpd"], j["nlpd"], rtol=1e-9, atol=1e-9)


# the NLPD without eig_floor: −log p(y*) / n, by a dense Cholesky factor with escalating
# jitter up to max_cholesky_size (800) test points, by mBCG with SLQ above it
NLPD_PROBES = 16
# mBCG against mBCG on the same probes: the two packages' CG iterations round differently
# in float64, and SLQ's tridiagonals carry it into the log-determinant (read 2.3e-13 at 400
# test points and 2.5e-11 at 40, where the exact covariance is less well conditioned)
NLPD_MBCG_RTOL = 1e-9


def _probe_draw(shape):
    """Injected standard-normal probe base samples, fixed by their shape."""
    return np.random.default_rng([11, *shape]).normal(size=shape)


def _mbcg_settings(mod):
    stack = contextlib.ExitStack()
    for ctx in (mod.max_cholesky_size(0), mod.max_preconditioner_size(0), mod.num_trace_samples(NLPD_PROBES),
                mod.cg_tolerance(1e-6), mod.max_cg_iterations(400), mod.max_lanczos_quadrature_iterations(100)):
        stack.enter_context(ctx)
    return stack


@functools.lru_cache(maxsize=None)
def _nlpds_without_floor(fast_pred_var, m):
    """Each package's NLPD of its own served predictive distribution (mean and dense
    covariance), by the dense Cholesky branch and by mBCG with injected probes."""
    served = _served(fast_pred_var, m)
    test_y = _task(N, m)[3]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys.modules["gpytorch_tpu.linop.base"], "probe_base_samples",
                   lambda key, shape, dtype: jnp.asarray(_probe_draw(tuple(shape)), dtype=dtype))

        @jax.jit
        def jax_nlpds(mean, cov, y):
            dist = gp.distributions.MultivariateNormal(mean, cov)
            with gp.settings.max_cholesky_size(800):
                chol = gp.metrics.negative_log_predictive_density(dist, y)
            with _mbcg_settings(gp.settings):
                mbcg = gp.metrics.negative_log_predictive_density(dist, y)
            return chol, mbcg

        j = served["jax"]
        out["jax"] = [float(x) for x in jax_nlpds(jnp.asarray(j["mean"]), jnp.asarray(j["cov"]), jnp.asarray(test_y))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys.modules["gpytorch_tpu_torch.linop.base"], "probe_base_samples",
                   lambda shape, dtype, device, source=None: torch.as_tensor(_probe_draw(tuple(shape)), dtype=dtype,
                                                                             device=device))
        t = served["torch"]
        dist = gt.distributions.MultivariateNormal(torch.from_numpy(t["mean"]), torch.from_numpy(t["cov"]))
        y = torch.from_numpy(test_y)
        with gt.settings.max_cholesky_size(800):
            chol = gt.metrics.negative_log_predictive_density(dist, y).item()
        with _mbcg_settings(gt.settings):
            mbcg = gt.metrics.negative_log_predictive_density(dist, y).item()
        out["torch"] = [chol, mbcg]
    return out


@pytest.mark.parametrize("fast_pred_var,m", [(True, M), (False, 40)])
def test_nlpd_without_floor_matches_jax_package(fast_pred_var, m):
    # at most 800 test points: the dense Cholesky branch of both packages' log_prob
    (want, _), (got, _) = (_nlpds_without_floor(fast_pred_var, m)[k] for k in ("jax", "torch"))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.mark.parametrize("fast_pred_var,m", [(True, M), (False, 40)])
def test_nlpd_without_floor_by_mbcg_matches_jax_package(fast_pred_var, m):
    # max_cholesky_size(0): mBCG with stochastic Lanczos quadrature, the same probes in both
    (chol, want), (_, got) = (_nlpds_without_floor(fast_pred_var, m)[k] for k in ("jax", "torch"))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=NLPD_MBCG_RTOL)
    assert abs(got - chol) < 0.05 * abs(chol)  # an estimate of the same density


@pytest.mark.parametrize("neg", [1e-9, 3e-8])
def test_nlpd_of_a_slightly_indefinite_covariance_matches_jax_package(neg):
    # one eigenvalue at −neg of the largest (1): an eigendecomposition's log is NaN there;
    # psd_safe_cholesky adds its base jitter 1e-8 (neg = 1e-9) or escalates to 1e-7
    # (neg = 3e-8), and both packages return the same finite value.  The residual lies
    # outside the near-null direction, so the value does not hang on its round-off.
    n = 300
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = rng.uniform(0.05, 1.0, size=n)
    w[0], w[1] = 1.0, -neg
    cov = (q * w) @ q.T
    cov = 0.5 * (cov + cov.T)
    assert np.linalg.eigvalsh(cov)[0] < 0
    mean = 0.1 * rng.normal(size=n)
    y = mean + q[:, 2:] @ (0.3 * rng.normal(size=n - 2))
    want = float(jax.jit(lambda a, c, b: gp.metrics.negative_log_predictive_density(
        gp.distributions.MultivariateNormal(a, c), b))(jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(y)))
    dist = gt.distributions.MultivariateNormal(torch.from_numpy(mean), torch.from_numpy(cov))
    got = gt.metrics.negative_log_predictive_density(dist, torch.from_numpy(y)).item()
    assert np.isfinite(got) and np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_load_jax_params_carries_the_constrained_values():
    train_x, train_y, _, _, _ = _task(50, 0)
    jm = JaxModel(jnp.asarray(train_x), jnp.asarray(train_y), gp.likelihoods.GaussianLikelihood())
    params = {k: np.asarray(v) for k, v in jm.with_params({k: jnp.asarray(v) for k, v in PARAMS.items()}).trainable_params().items()}
    assert set(params) == set(PARAMS)
    jm = jm.with_params({k: jnp.asarray(v) for k, v in params.items()})
    tm = gt.load_jax_params(TorchModel(torch.from_numpy(train_x), torch.from_numpy(train_y),
                                       gt.likelihoods.GaussianLikelihood()).double(), params)
    pairs = [
        (tm.covar_module.base_kernel.lengthscale, jm.covar_module.base_kernel.lengthscale),
        (tm.covar_module.outputscale, jm.covar_module.outputscale),
        (tm.likelihood.noise, jm.likelihood.noise),
        (tm.mean_module.constant, jm.mean_module.constant),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize(
    "change,error",
    [(lambda p: {**p, "covar_module.raw_lengthscale": np.zeros((1, 3))}, KeyError),
     (lambda p: {k: v for k, v in p.items() if k != "mean_module.raw_constant"}, KeyError),
     (lambda p: {**p, "likelihood.noise_covar.raw_noise": np.zeros(2)}, ValueError)],
)
def test_load_jax_params_rejects_mismatches(change, error):
    tm = TorchModel(torch.zeros(5, D), torch.zeros(5), gt.likelihoods.GaussianLikelihood())
    with pytest.raises(error):
        gt.load_jax_params(tm, change(PARAMS))


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gpytorch_tpu_torch as pkg\n"
        "for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'gpytorch_tpu.')) or m == 'gpytorch_tpu')\n"
        "assert not bad, bad\n"
    )
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_every_kernel_product_takes_the_fused_path_with_contiguous_inputs(monkeypatch):
    # The CUDA kernel takes only contiguous float32 tensors; on the CPU the same dispatch
    # runs, so check here what the serving path hands it, and how often: one product per
    # CG iteration, one per Lanczos block (5), and two per request (mean and LOVE).
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    calls = []
    plain = fk.fused_kernel_matvec

    def checked(x1, x2, v, kernel_type):
        assert all(t.is_contiguous() and t.dtype == torch.float32 for t in (x1, x2, v))
        calls.append(v.shape[1])
        return plain(x1, x2, v, kernel_type)

    monkeypatch.setattr(fk, "fused_kernel_matvec", checked)
    n, m = 600, 450  # n², n·m > max_eager_kernel_size², so both products stream
    train_x, train_y, test_x, _, _ = _task(n, m)
    tm = TorchModel(torch.from_numpy(train_x).float(), torch.from_numpy(train_y).float(),
                    gt.likelihoods.GaussianLikelihood())
    gt.load_jax_params(tm, PARAMS)
    tm.eval()
    with _serving_settings(gt.settings, True), torch.no_grad():
        strategy = tm.refresh()
        var = tm.likelihood(tm(torch.from_numpy(test_x).float())).variance
    iters = strategy.lik_train_train_covar.last_cg_result.num_iters
    assert calls == [1] * iters + [20] * 5 + [1, 100]
    assert torch.isfinite(var).all() and (var > 0).all()
