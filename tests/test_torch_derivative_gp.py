"""The port's derivative GPs against the JAX package, in float64 on the CPU.

* ``RBFKernelGrad``, ``RBFKernelGradGrad``, ``Matern52KernelGrad`` and ``PolynomialKernelGrad``:
  the interleaved matrix of two inputs and of one, and its diagonal; their refusal of
  ``last_dim_is_batch``; ``ConstantMeanGrad``, ``ConstantMeanGradGrad``, ``LinearMeanGrad`` and
  ``LinearMeanGradGrad``;
* the lazy operator of a grad kernel: its rows (what the pivoted-Cholesky preconditioner
  reads) and its product streamed by blocks of inputs, against its dense matrix;
* the derivative GP of ``tests/test_derivative_and_dspp.py`` (ConstantMeanGrad,
  ScaleKernel(RBFKernelGrad), MultitaskGaussianLikelihood without task noise): its MLL, the
  MLL's gradient in every raw parameter and the predictive mean, on the dense-Cholesky path
  (n = 24, d = 1) and by preconditioned mBCG (n = 150, d = 3: 600 observations above
  ``max_eager_kernel_size``, so that the port's products stream and its preconditioner
  reads the lazy operator's rows; the JAX side with its eager size raised past 600, so that
  its operator is dense);
* the JAX package's recursion above 800 observations under its default settings, and the
  port's MLL there against the JAX package's with the eager size raised.

The same numpy data, raw parameters and probe base samples go through both packages; the JAX
side gets float64 distances.  Tolerances are stated at each test.
"""

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
from gpytorch_tpu_torch.linop import lazy_kernel

D = 3
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


def _draw(shape):
    """Probe base samples fixed by their shape, the same in both packages."""
    return np.random.default_rng([5, *shape]).normal(size=shape)


def _jax_draw(key, shape, dtype):
    return jnp.asarray(_draw(tuple(shape)), dtype=dtype)


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    """Float64 distances in JAX, and the probes injected by shape."""
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    monkeypatch.setattr(gpytorch_tpu.linop.base, "probe_base_samples", _jax_draw)
    monkeypatch.setattr(gpytorch_tpu.linop.root, "probe_base_samples", _jax_draw)


def _moved(module, seed=1, scale=0.3):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v, dtype=np.float64) + scale * rng.normal(size=np.shape(v))
            for k, v in module.trainable_params().items()}


def _jnp(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _close(got, want, rtol):
    got = got.to_dense() if hasattr(got, "to_dense") else got
    want = np.asarray(want.to_dense() if hasattr(want, "to_dense") else want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


# -- kernels and means ----------------------------------------------------------------------

GRAD_KERNELS = {
    "rbf_grad": lambda pkg, f64: pkg.kernels.RBFKernelGrad(ard_num_dims=D, **f64),
    "rbf_grad_batch2": lambda pkg, f64: pkg.kernels.RBFKernelGrad(ard_num_dims=D, batch_shape=(2,), **f64),
    "rbf_gradgrad": lambda pkg, f64: pkg.kernels.RBFKernelGradGrad(ard_num_dims=D, **f64),
    "matern52_grad": lambda pkg, f64: pkg.kernels.Matern52KernelGrad(ard_num_dims=D, **f64),
    "polynomial_grad3": lambda pkg, f64: pkg.kernels.PolynomialKernelGrad(power=3, **f64),
    "polynomial_grad1": lambda pkg, f64: pkg.kernels.PolynomialKernelGrad(power=1, **f64),
    "scaled_rbf_grad": lambda pkg, f64: pkg.kernels.ScaleKernel(pkg.kernels.RBFKernelGrad(ard_num_dims=D, **f64),
                                                               **f64),
}


def _kernel_pair(name):
    jk = GRAD_KERNELS[name](gp, {"dtype": F64})
    params = _moved(jk)
    return jk.with_params(_jnp(params)), gt.load_jax_params(GRAD_KERNELS[name](gt, {}).double(), params)


def _points(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(n, D)), rng.uniform(-1, 1, size=(m, D))


@pytest.mark.parametrize("name", list(GRAD_KERNELS))
def test_grad_kernel_matches_jax_package(name):
    # the interleaved (n·A) × (m·A) matrix of two inputs and of one, and its diagonal;
    # 1e-10 relative to the largest entry
    jk, tk = _kernel_pair(name)
    x1, x2 = _points(9, 6)
    j1, j2, t1, t2 = jnp.asarray(x1), jnp.asarray(x2), torch.from_numpy(x1), torch.from_numpy(x2)
    with torch.no_grad():
        cross = tk(t1, t2)
        a = tk.num_outputs_per_input(t1, t2)
        assert cross.shape[-2:] == (9 * a, 6 * a)
        _close(cross, jk(j1, j2), 1e-10)
        _close(tk(t1), jk(j1), 1e-10)
        _close(tk(t1, t1, diag=True), jk(j1, j1, diag=True), 1e-10)
        # the diagonal is the matrix's
        np.testing.assert_allclose(tk(t1, t1, diag=True).numpy(),
                                   torch.diagonal(tk(t1).to_dense(), dim1=-2, dim2=-1).numpy(), rtol=1e-12)
    with pytest.raises(RuntimeError):
        jk(j1, j2, last_dim_is_batch=True).to_dense()
    with pytest.raises(RuntimeError):
        tk(t1, t2, last_dim_is_batch=True).to_dense()


MEANS = {
    "constant_grad": lambda pkg, f64: pkg.means.ConstantMeanGrad(**f64),
    "constant_gradgrad_batch2": lambda pkg, f64: pkg.means.ConstantMeanGradGrad(batch_shape=(2,), **f64),
    "linear_grad": lambda pkg, f64: pkg.means.LinearMeanGrad(D, **f64),
    "linear_grad_no_bias": lambda pkg, f64: pkg.means.LinearMeanGrad(D, bias=False, **f64),
    "linear_gradgrad": lambda pkg, f64: pkg.means.LinearMeanGradGrad(D, **f64),
}


@pytest.mark.parametrize("name", list(MEANS))
def test_grad_mean_matches_jax_package(name):
    # [m, ∇m] (and the zero second derivatives) of each input row, (…, n, d + 1) or
    # (…, n, 2d + 1); 1e-12
    jm = MEANS[name](gp, {"dtype": F64})
    params = _moved(jm)
    jm = jm.with_params(_jnp(params))
    tm = gt.load_jax_params(MEANS[name](gt, {}).double(), params)
    x = _points(7, 1)[0]
    got = tm(torch.from_numpy(x))
    want = np.asarray(jm(jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["rbf_grad", "rbf_grad_batch2", "matern52_grad"])
def test_grad_kernel_rows_and_streamed_product_match_dense(monkeypatch, name):
    # rows idx of the lazy operator (input idx // A, output idx mod A), per batch element for
    # a batched index, and its product by blocks of 4 inputs (16 rows), against the dense
    # matrix (1e-12); the JAX package's dense rows (1e-10)
    monkeypatch.setattr(lazy_kernel, "_CHUNK", 4)
    jk, tk = _kernel_pair(name)
    x1, x2 = _points(10, 7)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    op = tk(t1, t2)
    dense = op.to_dense().detach()
    idx = torch.tensor([0, 5, 39, 22, 3])
    rows = op._get_rows(idx).detach()
    np.testing.assert_allclose(rows.numpy(), dense[..., idx, :].numpy(), rtol=1e-12, atol=1e-12)
    want = np.asarray(jk(jnp.asarray(x1), jnp.asarray(x2)).to_dense())[..., idx.numpy(), :]
    np.testing.assert_allclose(rows.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    if op.batch_shape:
        per = torch.tensor([[1, 2, 3], [38, 4, 17]])
        np.testing.assert_allclose(op._get_rows(per).detach().numpy(),
                                   torch.stack([dense[i, per[i]] for i in range(2)]).numpy(), rtol=1e-12, atol=1e-12)
    v = torch.from_numpy(np.random.default_rng(4).normal(size=(28, 3)))
    with gt.settings.max_eager_kernel_size(8):
        got = op.matmul(v).detach()
    np.testing.assert_allclose(got.numpy(), (dense @ v).numpy(), rtol=1e-12, atol=1e-12)


# -- derivative GPs --------------------------------------------------------------------------

def _model(pkg, x, y, d, f64):
    class DerivativeGP(pkg.models.ExactGP):
        def __init__(self, tx, ty, likelihood):
            super().__init__(tx, ty, likelihood)
            self.mean_module = pkg.means.ConstantMeanGrad(**f64)
            self.covar_module = pkg.kernels.ScaleKernel(pkg.kernels.RBFKernelGrad(ard_num_dims=d, **f64), **f64)

        def forward(self, z):
            return pkg.distributions.MultitaskMultivariateNormal(self.mean_module(z), self.covar_module(z))

    likelihood = pkg.likelihoods.MultitaskGaussianLikelihood(num_tasks=d + 1, has_task_noise=False, **f64)
    return DerivativeGP(x, y, likelihood)


def _sine_task(n=24):
    # tests/test_derivative_and_dspp.py:34: f = sin 2πx and f' = 2π cos 2πx, d = 1
    x = np.linspace(0, 1, n)[:, None]
    return x, np.stack([np.sin(2 * np.pi * x[:, 0]), 2 * np.pi * np.cos(2 * np.pi * x[:, 0])], -1)


def _task(n, seed=0):
    """make_task's function of d = 3 inputs and its gradient, with noise 0.1 on each."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    a, b, c = x[:, 0], x[:, 1], x[:, 2]
    f = np.sin(4 * a) * np.cos(3 * b) + 0.5 * np.sin(7 * c * a) + 0.1 * c
    grad = [4 * np.cos(4 * a) * np.cos(3 * b) + 3.5 * c * np.cos(7 * c * a), -3 * np.sin(4 * a) * np.sin(3 * b),
            3.5 * a * np.cos(7 * c * a) + 0.1]
    return x, np.stack([f, *grad], -1) + 0.1 * rng.normal(size=(n, D + 1))


def _mbcg(mod):
    stack = contextlib.ExitStack()
    for ctx in (mod.max_cholesky_size(0), mod.min_preconditioning_size(0), mod.max_preconditioner_size(20),
                mod.max_cg_iterations(1000), mod.cg_tolerance(1e-10), mod.eval_cg_tolerance(1e-10),
                mod.num_trace_samples(8), mod.max_lanczos_quadrature_iterations(30)):
        stack.enter_context(ctx)
    return stack


@functools.lru_cache(maxsize=None)
def _jax_derivative_gp(kind):
    """The JAX model's raw parameters (moved off their initial values), −MLL, its gradient and
    the predictive mean at test points, for the "cholesky" (n = 24, d = 1) or "mbcg" (n = 150,
    d = 3) case."""
    x, y = _sine_task() if kind == "cholesky" else _task(150)
    d = x.shape[-1]
    xs = np.linspace(0.05, 0.95, 9)[:, None] if kind == "cholesky" else _task(20, seed=1)[0]
    jm = _model(gp, jnp.asarray(x), jnp.asarray(y), d, {"dtype": F64})
    params = _moved(jm, seed=2, scale=0.2)
    eager = 10 * x.shape[0] * (d + 1)
    settings = (lambda: contextlib.nullcontext()) if kind == "cholesky" else (lambda: _mbcg(gp.settings))

    def loss(p):
        m = jm.with_params(p)
        with settings(), gp.settings.max_eager_kernel_size(eager):
            return -gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(jnp.asarray(x)), jnp.asarray(y),
                                                                         key=jax.random.PRNGKey(0))

    value, grad = jax.jit(jax.value_and_grad(loss))(_jnp(params))
    with settings(), gp.settings.max_eager_kernel_size(eager):
        mean = jm.with_params(_jnp(params)).eval()(jnp.asarray(xs)).mean
    return (x, y, xs), params, float(value), {k: np.asarray(g) for k, g in grad.items()}, np.asarray(mean)


@pytest.mark.parametrize("kind", ["cholesky", "mbcg"])
def test_derivative_gp_matches_jax_package(kind):
    # Cholesky: n·(d + 1) = 48 ≤ max_cholesky_size, one dense factor in both; 1e-10.
    # mBCG (600 observations): the rank-20 preconditioner, 8 injected probes, CG at 1e-10 and
    # 30 Lanczos steps; the port at its default max_eager_kernel_size (products by blocks of
    # inputs, the preconditioner from the lazy operator's rows); 1e-8, as the exact-GP
    # training parity: both run the same float64 arithmetic in another order through CG
    (x, y, xs), params, want, want_grad, want_mean = _jax_derivative_gp(kind)
    rtol = 1e-10 if kind == "cholesky" else 1e-8
    model = gt.load_jax_params(_model(gt, torch.from_numpy(x), torch.from_numpy(y), x.shape[-1], {}).double(), params)
    settings = contextlib.nullcontext() if kind == "cholesky" else _mbcg(gt.settings)
    with settings:
        op = model(model.train_inputs[0]).lazy_covariance_matrix
        assert isinstance(op, gt.linop.LazyEvaluatedKernelOperator) and op.shape[-1] == y.size
        loss = -gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)(model(model.train_inputs[0]),
                                                                             model.train_targets, base_samples=_draw)
        loss.backward()
        np.testing.assert_allclose(loss.item(), want, rtol=rtol)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want_grad[name], rtol=rtol,
                                       atol=rtol * np.abs(want_grad[name]).max(), err_msg=name)
        model.eval()
        with torch.no_grad():
            post = model(torch.from_numpy(xs))
        assert isinstance(post, gt.distributions.MultitaskMultivariateNormal) and post.mean.shape == want_mean.shape
        np.testing.assert_allclose(post.mean.numpy(), want_mean, rtol=0, atol=rtol * np.abs(want_mean).max())


def test_jax_recursion_above_800_observations_and_the_port_mll_there():
    # n = 300, d = 3: 1,200 observations, above the default max_cholesky_size (800) and
    # max_eager_kernel_size (512).  The JAX package's product of its lazy grad-kernel operator
    # calls evaluate_kernel, which returns the operator itself, so its MLL recurses without
    # end; the port streams the product by blocks of inputs and gives the MLL that the JAX
    # package gives with max_eager_kernel_size raised past 1,200 (a dense operator), with the
    # same injected probes (default settings otherwise: 10 unpreconditioned probes, CG at
    # tolerance 1); 1e-8
    x, y = _task(300)
    jm = _model(gp, jnp.asarray(x), jnp.asarray(y), D, {"dtype": F64})
    params = _moved(jm, seed=2, scale=0.2)
    jm = jm.with_params(_jnp(params))

    def jax_mll():
        return float(gp.mlls.ExactMarginalLogLikelihood(jm.likelihood, jm)(jm(jnp.asarray(x)), jnp.asarray(y),
                                                                            key=jax.random.PRNGKey(0)))

    with pytest.raises(RecursionError):
        jax_mll()
    with gp.settings.max_eager_kernel_size(1300):
        want = jax_mll()
    model = gt.load_jax_params(_model(gt, torch.from_numpy(x), torch.from_numpy(y), D, {}).double(), params)
    with torch.no_grad():
        got = gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)(model(model.train_inputs[0]),
                                                                           model.train_targets, base_samples=_draw)
    np.testing.assert_allclose(got.item(), want, rtol=1e-8)
