"""Indexing of the port's operators, and the multitask exact MLL under the NaN policy
"fill", against the JAX package, in float64 on the CPU.

* Any operator indexed by anything but two slices is its dense matrix indexed, as the JAX
  package's ``LinearOperator.__getitem__`` makes it (``gpytorch_tpu/linop/base.py:447-448``):
  an added-diagonal operator sliced, a lazy kernel operator indexed by an index tensor, an
  integer or a batch index, and an interpolated (KISS-GP) operator indexed by an index
  tensor.  Two slices still slice a lazy kernel's inputs and an interpolation's rows.
* The Kronecker multitask GP (60 inputs × 2 tasks, three NaN targets) under
  ``observation_nan_policy("fill")``: its MLL and gradient.  "mask" raises for a multitask
  output in both packages (the JAX package fails to broadcast its flat mask against the
  (n, t) target).

Tolerance 1e-12 for an indexed matrix (the same float64 entries), 1e-10 for the MLL (one
dense Cholesky factor in each package).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt

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


def _kernels(batch=()):
    """Scale(RBF-ARD) in both packages with the same raw parameters, on 50 inputs."""
    jk = gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=3, batch_shape=batch, dtype=F64), batch_shape=batch,
                                dtype=F64)
    rng = np.random.default_rng(1)
    params = {k: np.asarray(v, dtype=np.float64) + 0.3 * rng.normal(size=np.shape(v))
              for k, v in jk.trainable_params().items()}
    jk = jk.with_params({k: jnp.asarray(v) for k, v in params.items()})
    tk = gt.load_jax_params(gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=3, batch_shape=batch),
                                                   batch_shape=batch).double(), params)
    x = np.random.default_rng(0).uniform(size=(50, 3))
    return jk(jnp.asarray(x)), tk(torch.from_numpy(x))


def _close(got, want, rtol=1e-12):
    assert isinstance(got, gt.linop.LinearOperator)
    got = got.to_dense().detach().numpy()
    want = np.asarray(want.to_dense() if hasattr(want, "to_dense") else want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


IDX = np.array([3, 0, 41, 7, 7])


def test_added_diagonal_operator_slices_densely():
    # (K + 0.1·I)[0:5, 0:7]: the base class's dense fallback, (5, 7)
    jK, tK = _kernels()
    jop, top = jK.add_diagonal(jnp.asarray(0.1)), tK.add_diagonal(torch.tensor(0.1, dtype=torch.float64))
    got = top[0:5, 0:7]
    assert isinstance(got, gt.linop.DenseLinearOperator) and got.shape == (5, 7)
    _close(got, jop[0:5, 0:7])
    _close(top[IDX, :], jop[jnp.asarray(IDX), :])


@pytest.mark.parametrize("index", ["rows", "rows_and_columns", "slice_and_columns", "ellipsis_rows"])
def test_lazy_kernel_operator_index_tensor_matches_jax_package(index):
    # K[idx, :] is (5, 50) in both packages, from the dense matrix; index tensors of rows and
    # columns broadcast to (5, 5), a slice of rows and a tensor of columns give (7, 5)
    jK, tK = _kernels()
    t_ix, j_ix = {
        "rows": ((torch.from_numpy(IDX), slice(None)), (jnp.asarray(IDX), slice(None))),
        "rows_and_columns": ((torch.from_numpy(IDX[:, None]), torch.from_numpy(IDX[None, ::-1].copy())),
                             (jnp.asarray(IDX[:, None]), jnp.asarray(IDX[None, ::-1].copy()))),
        "slice_and_columns": ((slice(2, 9), torch.from_numpy(IDX)), (slice(2, 9), jnp.asarray(IDX))),
        "ellipsis_rows": ((Ellipsis, torch.from_numpy(IDX), slice(None)), (Ellipsis, jnp.asarray(IDX), slice(None))),
    }[index]
    with torch.no_grad():
        _close(tK[t_ix], jK[j_ix])


def test_lazy_kernel_operator_batch_index_and_slices():
    # a batch index of a batched kernel's operator is dense; two slices still slice the
    # inputs (a lazy operator of the sliced inputs, symmetric where the slices are equal)
    jK, tK = _kernels(batch=(2,))
    with torch.no_grad():
        _close(tK[1], jK[1])
        _close(tK[torch.tensor([1, 0])], jK[jnp.asarray([1, 0])])
        sliced = tK[..., 5:20, 5:20]
        assert isinstance(sliced, gt.linop.LazyEvaluatedKernelOperator) and sliced.symmetric
        _close(sliced, jK[..., 5:20, 5:20])


def _interpolated():
    """W K_UU Wᵀ of 30 points on a grid of 12 (4 interpolation weights a row) in both."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(12, 12))
    base = a @ a.T + 12 * np.eye(12)
    idx = np.sort(rng.integers(0, 12, size=(30, 4)), axis=-1)
    vals = rng.uniform(size=(30, 4))
    jop = gp.linop.InterpolatedLinearOperator(gp.linop.DenseLinearOperator(jnp.asarray(base)), jnp.asarray(idx),
                                              jnp.asarray(vals))
    top = gt.linop.InterpolatedLinearOperator(gt.linop.DenseLinearOperator(torch.from_numpy(base)),
                                              torch.from_numpy(idx), torch.from_numpy(vals))
    return jop, top


def test_interpolated_operator_index_tensor_matches_jax_package():
    # an index tensor of rows, or of columns, from the dense matrix; two slices still slice
    # the interpolation rows
    jop, top = _interpolated()
    rows = np.array([3, 0, 21, 7])
    _close(top[torch.from_numpy(rows), :], jop[jnp.asarray(rows), :])
    _close(top[..., 2:9, torch.from_numpy(rows)], jop[..., 2:9, jnp.asarray(rows)])
    sliced = top[3:11, 0:5]
    assert isinstance(sliced, gt.linop.InterpolatedLinearOperator)
    _close(sliced, jop[3:11, 0:5])


def _kron_task(n=60, t=2):
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, n)
    y = np.stack([np.sin(6 * x), np.cos(5 * x)], -1) + 0.1 * rng.normal(size=(n, t))
    y[[4, 17, 33], [0, 1, 0]] = np.nan
    return x, y


def _kron_model(pkg, x, y):
    class MultitaskGP(pkg.models.ExactGP):
        def __init__(self, tx, ty, likelihood):
            super().__init__(tx, ty, likelihood)
            self.mean_module = pkg.means.MultitaskMean(pkg.means.ConstantMean(), num_tasks=2)
            self.covar_module = pkg.kernels.MultitaskKernel(pkg.kernels.RBFKernel(), num_tasks=2, rank=1)

        def forward(self, z):
            return pkg.distributions.MultitaskMultivariateNormal(self.mean_module(z), self.covar_module(z))

    return MultitaskGP(x, y, pkg.likelihoods.MultitaskGaussianLikelihood(num_tasks=2))


def test_multitask_fill_policy_matches_jax_package():
    # NaN targets replaced by the prior mean; MLL and gradient in every raw parameter, 1e-10
    x, y = _kron_task()
    jm = _kron_model(gp, jnp.asarray(x), jnp.asarray(y))
    rng = np.random.default_rng(3)
    params = {k: np.asarray(v, dtype=np.float64) + 0.2 * rng.normal(size=np.shape(v))
              for k, v in jm.trainable_params().items()}

    def loss(p, policy):
        m = jm.with_params(p)
        with gp.settings.observation_nan_policy(policy):
            return gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(jnp.asarray(x)), jnp.asarray(y))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want, want_grad = jax.jit(jax.value_and_grad(lambda p: loss(p, "fill")))(jp)
    assert np.isfinite(float(want))
    with pytest.raises(ValueError):
        loss(jp, "mask")
    model = gt.load_jax_params(_kron_model(gt, torch.from_numpy(x), torch.from_numpy(y)).double(), params)
    mll = gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)
    with gt.settings.observation_nan_policy("fill"):
        got = mll(model(model.train_inputs[0]), model.train_targets)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-10)
    for name, p in model.named_parameters():
        w = np.asarray(want_grad[name])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-10, atol=1e-10 * np.abs(w).max(), err_msg=name)
    with gt.settings.observation_nan_policy("mask"), pytest.raises(NotImplementedError):
        mll(model(model.train_inputs[0]), model.train_targets)
