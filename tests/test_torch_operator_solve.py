"""``LinearOperator.solve`` by CG, differentiated through its right-hand side and through the
operator (``gpytorch_tpu_torch/linop/base.py::_Solve``), against ``jax.grad`` of the JAX
package's ``linear_solve_cg`` (``gpytorch_tpu/solvers/cg.py:285-343``), in float64 on the CPU
from the same numpy inputs.  Each backward solve is refined as its forward solve is."""

import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt
from gpytorch_tpu.solvers.cg import linear_solve_cg as jax_linear_solve_cg


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(**settings_kw):
    stack = contextlib.ExitStack()
    for mod in (gp.settings, gt.settings):
        for name, value in settings_kw.items():
            stack.enter_context(getattr(mod, name)(value))
    return stack


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, 3)), rng.normal(size=(n, 2)), rng.normal(size=(n, 2))


def _kernel(xp, x, theta):
    """θ₀ exp(−|x_i − x_j|² / (2 θ₁²)) + θ₂ I in either package (``xp`` is jnp or torch)."""
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return theta[0] * xp.exp(-0.5 * d2 / theta[1] ** 2)


# A loose solve, as a short CG at tolerance 0.3 gives: its refined and unrefined solutions
# (and so their gradients) differ by far more than the parity tolerance.
LOOSE = dict(cg_tolerance=0.3, cg_stall_window=50, max_cholesky_size=0, min_preconditioning_size=10**6)
THETA = np.array([1.0, 0.2, 0.3])


def _jax_value_and_grads(x, b, w, refinements):
    def f(bb, theta):
        op = gp.linop.DenseLinearOperator(_kernel(jnp, jnp.asarray(x), theta)).add_diagonal(theta[2])
        return jnp.sum(jnp.asarray(w) * jax_linear_solve_cg(op, bb))

    with _both(**LOOSE, solve_iterative_refinements=refinements):
        value, grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(jnp.asarray(b), jnp.asarray(THETA))
    return float(value), np.asarray(grads[0]), np.asarray(grads[1])


def _torch_value_and_grads(x, b, w, refinements, operator_grad=True):
    bt = torch.from_numpy(b).requires_grad_(True)
    theta = torch.from_numpy(THETA).requires_grad_(operator_grad)
    with _both(**LOOSE, solve_iterative_refinements=refinements):
        op = gt.linop.DenseLinearOperator(_kernel(torch, torch.from_numpy(x), theta)).add_diagonal(theta[2])
        value = (torch.from_numpy(w) * op.solve(bt)).sum()
    # the backward runs after the settings have gone out of scope: it must use the forward's
    value.backward()
    return value.item(), bt.grad.numpy(), (theta.grad.numpy() if operator_grad else None), op


def test_refined_solve_gradient_matches_jax_package():
    # The gradient with respect to b alone (the operator carries none): the backward solve
    # u = A⁻¹w is refined as the forward is (JAX: _cg_solve_fwd_impl inside the VJP).  An
    # unrefined backward reads the unrefined gradient, which at this tolerance lies far
    # outside the parity tolerance (asserted below).
    x, b, w = _inputs(200)
    v1, gb1, _, op = _torch_value_and_grads(x, b, w, 1, operator_grad=False)
    want_v, want_b, _ = _jax_value_and_grads(x, b, w, 1)
    _, gb0, _, _ = _torch_value_and_grads(x, b, w, 0, operator_grad=False)
    tol = 1e-8
    np.testing.assert_allclose(v1, want_v, rtol=tol)
    np.testing.assert_allclose(gb1, want_b, rtol=0, atol=tol * np.abs(want_b).max())
    assert np.abs(gb1 - gb0).max() > 1e3 * tol * np.abs(want_b).max()
    assert op.last_cg_result.num_iters > 1


@pytest.mark.parametrize("refinements", [0, 2])
def test_operator_cotangents_match_jax_package(refinements):
    # the gradient with respect to the operator's tensors: θ reaches the operator through
    # a dense kernel matrix and the added diagonal
    x, b, w = _inputs(150, seed=1)
    v, gb, gth, _ = _torch_value_and_grads(x, b, w, refinements)
    want_v, want_b, want_t = _jax_value_and_grads(x, b, w, refinements)
    np.testing.assert_allclose(v, want_v, rtol=1e-8)
    np.testing.assert_allclose(gb, want_b, rtol=0, atol=1e-8 * np.abs(want_b).max())
    np.testing.assert_allclose(gth, want_t, rtol=1e-8)


def _exact_float64_sq_dist(x1, x2, x1_eq_x2=False):
    adj = jnp.mean(x1, axis=-2, keepdims=True)
    x1, x2 = x1 - adj, x2 - adj
    res = (-2.0 * jnp.matmul(x1, jnp.swapaxes(x2, -1, -2), precision=jax.lax.Precision.HIGHEST)
           + jnp.sum(x1 * x1, -1, keepdims=True) + jnp.swapaxes(jnp.sum(x2 * x2, -1, keepdims=True), -1, -2))
    if x1_eq_x2:
        res = res * (1.0 - jnp.eye(res.shape[-1], dtype=res.dtype))
    return jnp.maximum(res, 0.0)


RAW = {"base_kernel.raw_lengthscale": np.array([[-1.0, -0.5, -1.2]]), "raw_outputscale": np.array(0.3)}


@pytest.mark.parametrize("t", [1, 3])
def test_lazy_kernel_solve_gradient_matches_jax_package(t, monkeypatch):
    # ScaleKernel(RBF-ARD) + σ²I at N=300 through the port's fused products (the symmetric
    # backward's plain twin for the operator's cotangent: dx and dos), against the JAX
    # package on its dense kernel: the gradients of Σ w ⊙ A⁻¹B with respect to the raw
    # hyperparameters, the noise, the inputs and B, at a tight tolerance
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    n = 300
    rng = np.random.default_rng(2)
    x, b, w = rng.uniform(size=(n, 3)), rng.normal(size=(n, t)), rng.normal(size=(n, t))
    tight = dict(cg_tolerance=1e-10, cg_stall_window=50, max_cholesky_size=0, min_preconditioning_size=0,
                 max_preconditioner_size=50, preconditioner_noise_budget=1e-3)

    def f(raw, noise, xx, bb):
        kern = gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=3)).with_params(raw)
        op = kern(xx).evaluate_kernel().add_diagonal(noise)
        return jnp.sum(jnp.asarray(w) * jax_linear_solve_cg(op, bb))

    with _both(**tight):
        raw_j = {k: jnp.asarray(v) for k, v in RAW.items()}
        want = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3)))(raw_j, jnp.asarray(0.05), jnp.asarray(x),
                                                                   jnp.asarray(b))

    kern = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=3)).double()
    with torch.no_grad():
        for name, value in RAW.items():
            kern.get_parameter(name).copy_(torch.from_numpy(value))
    noise = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    xt, bt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    with _both(**tight), gt.settings.max_eager_kernel_size(16):
        op = kern(xt).evaluate_kernel().add_diagonal(noise)
        assert isinstance(op.base, gt.linop.LazyEvaluatedKernelOperator)
        value = (torch.from_numpy(w) * op.solve(bt)).sum()
    value.backward()
    tol = 1e-7
    np.testing.assert_allclose(value.item(), float(want[0]), rtol=tol)
    for name in RAW:
        got = kern.get_parameter(name).grad.numpy()
        np.testing.assert_allclose(got, np.asarray(want[1][0][name]), rtol=tol, atol=tol * np.abs(got).max())
    np.testing.assert_allclose(noise.grad.item(), float(want[1][1]), rtol=tol)
    for got, w_ in ((xt.grad.numpy(), want[1][2]), (bt.grad.numpy(), want[1][3])):
        np.testing.assert_allclose(got, np.asarray(w_), rtol=0, atol=tol * np.abs(np.asarray(w_)).max())


def test_solve_without_gradients_takes_no_autograd_function():
    # under no_grad, or with nothing that requires grad, the solve is a plain CG solve
    x, b, _ = _inputs(120)
    K = torch.from_numpy(_kernel(np, x, THETA))
    op = gt.linop.DenseLinearOperator(K).add_diagonal(torch.tensor(THETA[2], dtype=torch.float64))
    with gt.settings.max_cholesky_size(0), gt.settings.cg_tolerance(1e-10):
        sol = op.solve(torch.from_numpy(b))
    assert sol.grad_fn is None
    np.testing.assert_allclose(sol.numpy(), np.linalg.solve(K.numpy() + THETA[2] * np.eye(120), b), rtol=1e-7, atol=1e-9)


class _UnflattenedSum(gt.linop.SumLinearOperator):
    """A sum that cannot be flattened (the port's sums can: multitask training
    differentiates through them)."""

    def _flatten(self):
        raise NotImplementedError

    def evaluate_kernel(self):
        return self


def test_solve_of_an_operator_without_flatten_and_a_leaf_under_no_grad():
    # an operator that cannot be flattened solves by plain CG while grad mode is on and
    # nothing needs a gradient, and raises only when its right-hand side does; under
    # no_grad a right-hand side that requires grad is solved without gradients
    x, b, _ = _inputs(120)
    K = torch.from_numpy(_kernel(np, x, THETA))
    want = np.linalg.solve(K.numpy() + THETA[2] * np.eye(120), b)
    summed = _UnflattenedSum(gt.linop.DenseLinearOperator(K),
                             gt.linop.DiagLinearOperator(torch.full((120,), THETA[2], dtype=torch.float64)))
    leaf = torch.from_numpy(b).requires_grad_(True)
    with gt.settings.max_cholesky_size(0), gt.settings.cg_tolerance(1e-10):
        sol = summed.solve(torch.from_numpy(b))
        with pytest.raises(NotImplementedError):
            summed.solve(leaf)
        with torch.no_grad():
            sol_leaf = gt.linop.DenseLinearOperator(K).add_diagonal(torch.tensor(THETA[2], dtype=torch.float64)).solve(leaf)
    assert sol.grad_fn is None and sol_leaf.grad_fn is None
    for got in (sol, sol_leaf):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=1e-9)
