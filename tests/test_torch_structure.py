"""The port's ``last_dim_is_batch``, structure kernels and composite kernels against the JAX
package, in float64 on the CPU.

* ``last_dim_is_batch`` on RBF, Matérn (ν = 0.5, 1.5, 2.5), periodic (its per-dimension
  lengthscales), ScaleKernel, GridKernel on its grid and GridInterpolationKernel (one 1D grid
  a dimension, or the one grid of a kernel of one grid dimension): one matrix per input
  dimension, (…, d, n, m), and its diagonal;
* ``AdditiveStructureKernel``, ``ProductStructureKernel`` and ``NewtonGirardAdditiveKernel``;
* ``AdditiveKernel`` and ``ProductKernel`` (``k1 + k2``, ``k1 * k2``) with per-kernel
  ``active_dims``;
* an exact GP with the SKIP kernel (ProductStructureKernel(ScaleKernel(GridInterpolationKernel(
  RBFKernel(), grid_size=64, num_dims=1)), num_dims=3)): its MLL and gradient, and its
  posterior mean;
* ``InterpolatedLinearOperator`` with batched interpolation: products (Wᵀ· a segment sum per
  element) and its dense matrix.

The same numpy inputs and raw parameters go through both packages; the JAX side gets float64
distances (its ``sq_dist`` forms the distance product in float32 even under x64).  A grid
made from the inputs is carried from the JAX kernel to the port through ``load_jax_params``.
Tolerance 1e-10 relative wherever both packages run the same float64 arithmetic in another
order, stated at each test.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt
from gpytorch_tpu.kernels import structure_kernels as jsk

D = 3
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


def _exact_float64_dist(x1, x2, x1_eq_x2=False):
    return jnp.sqrt(jnp.maximum(_exact_float64_sq_dist(x1, x2, x1_eq_x2), 1e-30))


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_dist_op", _exact_float64_dist)


def _inputs(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, D)), rng.uniform(size=(m, D))


def _moved(jk, seed=1):
    """The JAX kernel's raw parameters moved off their initial values, as numpy."""
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v, dtype=np.float64) + 0.3 * rng.normal(size=np.shape(v))
            for k, v in jk.trainable_params().items()}


def _pair(make_jax, make_torch, state=()):
    """A JAX kernel and the port's with the same raw parameters (and grid ``state``)."""
    jk = make_jax()
    params = _moved(jk)
    jk = jk.with_params({k: jnp.asarray(v) for k, v in params.items()})
    tk = gt.load_jax_params(make_torch().double(), {**params, **dict(state)})
    return jk, tk


def _dense(op):
    return np.asarray(op.to_dense() if hasattr(op, "to_dense") else op)


KERNELS = {
    "rbf": (lambda: gp.kernels.RBFKernel(ard_num_dims=D, dtype=F64), lambda: gt.kernels.RBFKernel(ard_num_dims=D)),
    "matern05": (lambda: gp.kernels.MaternKernel(nu=0.5, ard_num_dims=D, dtype=F64),
                 lambda: gt.kernels.MaternKernel(nu=0.5, ard_num_dims=D)),
    "matern15": (lambda: gp.kernels.MaternKernel(nu=1.5, dtype=F64), lambda: gt.kernels.MaternKernel(nu=1.5)),
    "matern25": (lambda: gp.kernels.MaternKernel(nu=2.5, ard_num_dims=D, dtype=F64),
                 lambda: gt.kernels.MaternKernel(nu=2.5, ard_num_dims=D)),
    "periodic": (lambda: gp.kernels.PeriodicKernel(ard_num_dims=D, dtype=F64),
                 lambda: gt.kernels.PeriodicKernel(ard_num_dims=D)),
    "scaled_rbf_batch2": (
        lambda: gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=D, batch_shape=(2,), dtype=F64),
                                       batch_shape=(2,), dtype=F64),
        lambda: gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D, batch_shape=(2,)), batch_shape=(2,))),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_last_dim_is_batch_matches_jax_package(name):
    # one matrix per input dimension, (…, d, n, m), its symmetric form and the diagonal;
    # 1e-10 relative
    jk, tk = _pair(*KERNELS[name])
    x1, x2 = _inputs(17, 11)
    j1, j2, t1, t2 = jnp.asarray(x1), jnp.asarray(x2), torch.from_numpy(x1), torch.from_numpy(x2)
    with torch.no_grad():
        got = tk(t1, t2, last_dim_is_batch=True)
        sym = tk(t1, last_dim_is_batch=True)
        diag = tk(t1, t1, diag=True, last_dim_is_batch=True)
    assert got.shape[-3:] == (D, 17, 11)
    for a, b in ((got.to_dense(), jk(j1, j2, last_dim_is_batch=True)), (sym.to_dense(), jk(j1, last_dim_is_batch=True)),
                 (diag, jk(j1, j1, diag=True, last_dim_is_batch=True))):
        want = _dense(b)
        np.testing.assert_allclose(a.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    v = torch.from_numpy(np.random.default_rng(2).normal(size=got.shape[:-2] + (11, 2)))
    with torch.no_grad():
        np.testing.assert_allclose(got.matmul(v).numpy(), got.to_dense().numpy() @ v.numpy(), rtol=1e-12, atol=1e-12)


def _grid_interp(num_dims, grid_size=24):
    def make_jax():
        return gp.kernels.GridInterpolationKernel(gp.kernels.RBFKernel(dtype=F64), grid_size=grid_size,
                                                  num_dims=num_dims, dtype=F64)

    def make_torch():
        return gt.kernels.GridInterpolationKernel(gt.kernels.RBFKernel(), grid_size=grid_size, num_dims=num_dims)

    return make_jax, make_torch


def _grid_state(jk, prefix=""):
    """The JAX grid kernel's grid, fitted eagerly to the inputs, under load_jax_params' names."""
    return {f"{prefix}grid": [np.asarray(g) for g in jk.grid], f"{prefix}grid_bounds": np.asarray(jk.grid_bounds),
            f"{prefix}has_initialized_grid": np.asarray(jk.has_initialized_grid)}


@pytest.mark.parametrize("num_dims", [1, 3], ids=["one_grid", "grid_per_dim"])
def test_grid_interpolation_last_dim_is_batch_matches_jax_package(num_dims):
    # every input dimension interpolated alone: on its own 1D grid (num_dims = 3) or on the
    # one grid (num_dims = 1, as SKIP builds it); the grids fitted eagerly by the JAX kernel
    # and carried over.  (d, n, m) dense, and the diagonal; 1e-10
    x1, x2 = _inputs(30, 30)
    x2 = 0.9 * x2 + 0.05
    make_jax, make_torch = _grid_interp(num_dims)
    jk = make_jax()
    j1, j2 = jnp.asarray(x1), jnp.asarray(x2)
    jk(j1, last_dim_is_batch=True).to_dense()  # fits the dynamic grid eagerly
    jk = jk.with_params({k: jnp.asarray(v) for k, v in _moved(jk).items()})
    tk = gt.load_jax_params(make_torch().double(), {**_moved(make_jax()), **_grid_state(jk)})
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    with torch.no_grad():
        got = tk(t1, t2, last_dim_is_batch=True).to_dense().numpy()
        diag = tk(t1, t1, diag=True, last_dim_is_batch=True).numpy()
    want = _dense(jk(j1, j2, last_dim_is_batch=True))
    assert got.shape == (D, 30, 30)
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=RTOL, atol=RTOL * np.abs(want).max())
    want_diag = np.asarray(jk(j1, j1, diag=True, last_dim_is_batch=True))
    np.testing.assert_allclose(diag, want_diag.reshape(diag.shape), rtol=RTOL, atol=RTOL * np.abs(want_diag).max())


def test_grid_kernel_on_its_grid_last_dim_is_batch_matches_jax_package():
    # a GridKernel on its own 2D grid: the per-dimension Toeplitz matrices densified and
    # stacked (2, m, m); 1e-10
    grid = [np.linspace(0, 1, 6), np.linspace(-1, 1, 6)]
    jk = gp.kernels.GridKernel(gp.kernels.RBFKernel(dtype=F64), [jnp.asarray(g) for g in grid], dtype=F64)
    params = _moved(jk)
    jk = jk.with_params({k: jnp.asarray(v) for k, v in params.items()})
    tk = gt.load_jax_params(gt.kernels.GridKernel(gt.kernels.RBFKernel(), [torch.from_numpy(g) for g in grid]).double(),
                            params)
    full = np.asarray(gp.utils.grid.create_data_from_grid([jnp.asarray(g) for g in grid]))
    with torch.no_grad():
        got = tk(torch.from_numpy(full), last_dim_is_batch=True).to_dense().numpy()
    want = _dense(jk(jnp.asarray(full), last_dim_is_batch=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


STRUCTURES = {
    "additive_structure": (
        lambda: jsk.AdditiveStructureKernel(gp.kernels.ScaleKernel(gp.kernels.RBFKernel(dtype=F64), dtype=F64),
                                            num_dims=D, dtype=F64),
        lambda: gt.kernels.AdditiveStructureKernel(gt.kernels.ScaleKernel(gt.kernels.RBFKernel()), num_dims=D)),
    "product_structure_matern": (
        lambda: jsk.ProductStructureKernel(gp.kernels.MaternKernel(nu=1.5, ard_num_dims=D, dtype=F64), num_dims=D,
                                           dtype=F64),
        lambda: gt.kernels.ProductStructureKernel(gt.kernels.MaternKernel(nu=1.5, ard_num_dims=D), num_dims=D)),
    "newton_girard_degree2": (
        lambda: jsk.NewtonGirardAdditiveKernel(gp.kernels.RBFKernel(ard_num_dims=D, dtype=F64), num_dims=D,
                                               max_degree=2, dtype=F64),
        lambda: gt.kernels.NewtonGirardAdditiveKernel(gt.kernels.RBFKernel(ard_num_dims=D), num_dims=D, max_degree=2)),
    "newton_girard_all_orders": (
        lambda: jsk.NewtonGirardAdditiveKernel(gp.kernels.PeriodicKernel(ard_num_dims=D, dtype=F64), num_dims=D,
                                               dtype=F64),
        lambda: gt.kernels.NewtonGirardAdditiveKernel(gt.kernels.PeriodicKernel(ard_num_dims=D), num_dims=D)),
    "additive_kernel": (
        lambda: (gp.kernels.RBFKernel(active_dims=(0,), dtype=F64)
                 + gp.kernels.ScaleKernel(gp.kernels.MaternKernel(nu=2.5, ard_num_dims=2, dtype=F64), active_dims=(1, 2),
                                          dtype=F64)),
        lambda: (gt.kernels.RBFKernel(active_dims=(0,))
                 + gt.kernels.ScaleKernel(gt.kernels.MaternKernel(nu=2.5, ard_num_dims=2), active_dims=(1, 2)))),
    "product_kernel": (
        lambda: (gp.kernels.RBFKernel(active_dims=(0, 2), ard_num_dims=2, dtype=F64)
                 * gp.kernels.PeriodicKernel(active_dims=(1,), dtype=F64)
                 * gp.kernels.ScaleKernel(gp.kernels.RBFKernel(dtype=F64), dtype=F64)),
        lambda: (gt.kernels.RBFKernel(active_dims=(0, 2), ard_num_dims=2)
                 * gt.kernels.PeriodicKernel(active_dims=(1,))
                 * gt.kernels.ScaleKernel(gt.kernels.RBFKernel()))),
}


@pytest.mark.parametrize("name", list(STRUCTURES))
def test_structure_and_composite_kernels_match_jax_package(name):
    # the dense matrix (symmetric and cross) and the diagonal; 1e-10
    jk, tk = _pair(*STRUCTURES[name])
    x1, x2 = _inputs(19, 13, seed=3)
    j1, j2, t1, t2 = jnp.asarray(x1), jnp.asarray(x2), torch.from_numpy(x1), torch.from_numpy(x2)
    with torch.no_grad():
        pairs = ((tk(t1).to_dense(), jk(j1)), (tk(t1, t2).to_dense(), jk(j1, j2)),
                 (tk(t1, t1, diag=True), jk(j1, j1, diag=True)))
    for got, want in pairs:
        want = _dense(want)
        np.testing.assert_allclose(got.numpy(), want.reshape(got.shape), rtol=RTOL, atol=RTOL * np.abs(want).max())
    if name.startswith("newton"):
        assert tk.outputscale.shape == (tk.max_degree,)
    if "structure" in name or name.startswith("newton"):  # their base kernel takes the input dimensions
        with pytest.raises(RuntimeError, match="last_dim_is_batch"):
            tk(t1, t2, last_dim_is_batch=True).to_dense()


def _skip_model(pkg, x, y, grid_size=64):
    f64 = {"dtype": F64} if pkg is gp else {}

    class SkipGP(pkg.models.ExactGP):
        def __init__(self, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = pkg.means.ConstantMean(**f64)
            grid = pkg.kernels.GridInterpolationKernel(pkg.kernels.RBFKernel(**f64), grid_size=grid_size, num_dims=1,
                                                       **f64)
            structure = jsk.ProductStructureKernel if pkg is gp else gt.kernels.ProductStructureKernel
            self.covar_module = structure(pkg.kernels.ScaleKernel(grid, **f64), num_dims=D, **f64)

        def forward(self, z):
            return pkg.distributions.MultivariateNormal(self.mean_module(z), self.covar_module(z))

    return SkipGP(pkg.likelihoods.GaussianLikelihood(**f64))


def _skip_task(n, q, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n + q, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * x[:, 2] + 0.1 * rng.normal(size=n + q)
    return x, y


def test_skip_gp_mll_gradient_and_posterior_match_jax_package():
    # SKIP at N=300 on a 64-point grid (fitted eagerly by the JAX kernel, carried over): the
    # port's MLL on the dense-Cholesky path, its gradient in every raw parameter, and the
    # posterior mean at 40 test points (inside the training range), against the same
    # quantities formed in JAX from the JAX package's SKIP kernel matrix (its ExactGP cannot
    # take that matrix: it comes out of batch shape (1, 1), its ScaleKernel's outputscale
    # reshaped against the per-dimension batch); 1e-8 relative
    n, q = 300, 40
    x, y = _skip_task(n, q)
    jm = _skip_model(gp, jnp.asarray(x[:n]), jnp.asarray(y[:n]))
    grid_kernel = jm.covar_module.base_kernel.base_kernel
    grid_kernel(jnp.asarray(x[:n]), last_dim_is_batch=True).to_dense()  # fits the dynamic grid eagerly
    params = _moved(jm, seed=5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jx, jy, jz = jnp.asarray(x[:n]), jnp.asarray(y[:n]), jnp.asarray(x[n:])

    def parts(p):
        m = jm.with_params(p)
        # with psd_safe_cholesky's float64 jitter, 1e-8, which the port's dense path adds
        k = m.covar_module(jx).to_dense().reshape(n, n) + (m.likelihood.noise[0] + 1e-8) * jnp.eye(n)
        return m, jnp.linalg.cholesky(k), jy - m.mean_module(jx)

    def loss(p):
        _, chol, r = parts(p)
        alpha = jax.scipy.linalg.cho_solve((chol, True), r)
        return (0.5 * r @ alpha + jnp.sum(jnp.log(jnp.diagonal(chol))) + 0.5 * n * jnp.log(2 * jnp.pi)) / n

    @jax.jit
    def posterior(p):
        m, chol, r = parts(p)
        cross = m.covar_module(jz, jx).to_dense().reshape(q, n)
        return cross @ jax.scipy.linalg.cho_solve((chol, True), r) + m.mean_module(jz)

    value, grad = jax.jit(jax.value_and_grad(loss))(jp)
    want_mean = np.asarray(posterior(jp))
    tm = _skip_model(gt, torch.from_numpy(x[:n]), torch.from_numpy(y[:n])).double()
    tm = gt.load_jax_params(tm, {**params, **_grid_state(grid_kernel, "covar_module.base_kernel.base_kernel.")})
    tloss = -gt.mlls.ExactMarginalLogLikelihood(tm.likelihood, tm)(tm(tm.train_inputs[0]), tm.train_targets)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(value), rtol=1e-8)
    for name, p in tm.named_parameters():
        want = np.asarray(grad[name])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-8, atol=1e-8 * np.abs(want).max(), err_msg=name)
    tm.eval()
    with torch.no_grad():
        mean = tm(torch.from_numpy(x[n:])).mean.numpy()
    np.testing.assert_allclose(mean, want_mean, rtol=1e-8, atol=1e-8 * np.abs(want_mean).max())


def test_batched_interpolation_products_match_dense_matrices():
    # W K Wᵀ with interpolation of batch (2, 3) against a base of batch (3,): the product,
    # the dense matrix, the diagonal and rows per element (what pivoted Cholesky reads)
    # against numpy's dense W_b K_b W_bᵀ; 1e-12.  The
    # unbatched Wᵀ· and its batched form give the same bits element by element
    rng = np.random.default_rng(6)
    n, m, q = 9, 7, 4
    base = rng.normal(size=(3, m, m))
    base = base @ base.swapaxes(-1, -2)
    idx = np.stack([np.stack([np.stack([np.random.default_rng([a, b, i]).choice(m, q, replace=False)
                                        for i in range(n)]) for b in range(3)]) for a in range(2)])
    vals = rng.normal(size=(2, 3, n, q))
    w = np.zeros((2, 3, n, m))
    np.put_along_axis(w, idx, vals, -1)
    dense = w @ base @ w.swapaxes(-1, -2)
    op = gt.linop.InterpolatedLinearOperator(gt.linop.DenseLinearOperator(torch.from_numpy(base)),
                                             torch.from_numpy(idx), torch.from_numpy(vals))
    assert op.shape == (2, 3, n, n)
    v = rng.normal(size=(2, 3, n, 2))
    np.testing.assert_allclose(op.matmul(torch.from_numpy(v)).numpy(), dense @ v, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op.to_dense().numpy(), dense, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op._diagonal().numpy(), np.diagonal(dense, axis1=-2, axis2=-1), rtol=1e-12, atol=1e-12)
    rows = torch.from_numpy(np.stack([rng.choice(n, 3, replace=False) for _ in range(6)]).reshape(2, 3, 3))
    np.testing.assert_allclose(op._get_rows(rows).numpy(), np.take_along_axis(dense, rows.numpy()[..., None], -2),
                               rtol=1e-12, atol=1e-12)
    from gpytorch_tpu_torch.ops.interp import dense_t, left_t_interp

    batched = left_t_interp(torch.from_numpy(idx), torch.from_numpy(vals), torch.from_numpy(v), m)
    for a in range(2):
        for b in range(3):
            one = left_t_interp(torch.from_numpy(idx[a, b]), torch.from_numpy(vals[a, b]), torch.from_numpy(v[a, b]), m)
            assert torch.equal(one, batched[a, b])
    eye = torch.eye(n, dtype=torch.float64)
    assert torch.equal(dense_t(torch.from_numpy(idx[0, 0]), torch.from_numpy(vals[0, 0]), m),
                       left_t_interp(torch.from_numpy(idx[0, 0]), torch.from_numpy(vals[0, 0]), eye, m))


def _batch_kiss_model(pkg, x, y, b=2, grid_size=64):
    f64 = {"dtype": F64} if pkg is gp else {}

    class BatchKissGP(pkg.models.ExactGP):
        def __init__(self, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = pkg.means.ConstantMean(batch_shape=(b,), **f64)
            base = pkg.kernels.ScaleKernel(pkg.kernels.RBFKernel(batch_shape=(b,), **f64), batch_shape=(b,), **f64)
            self.covar_module = pkg.kernels.GridInterpolationKernel(base, grid_size=grid_size, num_dims=1, **f64)

        def forward(self, z):
            return pkg.distributions.MultivariateNormal(self.mean_module(z), self.covar_module(z))

    return BatchKissGP(pkg.likelihoods.GaussianLikelihood(batch_shape=(b,), **f64))


@pytest.mark.parametrize("love", [False, True], ids=["exact", "love"])
def test_batched_kissgp_predictions_match_jax_package(love):
    # a KISS-GP of two outputs (a batched kernel on one 1D grid of 64 points, Toeplitz per
    # element) at N=300: the posterior mean and variances at 40 points inside the training
    # range, exact (dense Cholesky) or LOVE (a rank-60 root by
    # Lanczos from one start block, under max_cholesky_size(0) and CG at 1e-10), against the
    # JAX package; 1e-8 relative
    n, q, b = 300, 40, 2
    rng = np.random.default_rng(7)
    x = np.sort(rng.uniform(size=n))[:, None]
    y = np.stack([np.sin(6 * x[:, 0]), np.cos(4 * x[:, 0])]) + 0.1 * rng.normal(size=(b, n))
    test = np.linspace(x.min() + 0.01, x.max() - 0.01, q)[:, None]  # inside the grid: no refit
    jx = jnp.broadcast_to(jnp.asarray(x[:n]), (b, n, 1))
    jm = _batch_kiss_model(gp, jx, jnp.asarray(y[:, :n]))
    jm.covar_module(jx).to_dense()  # fits the dynamic grid eagerly
    params = _moved(jm, seed=8)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    settings = (lambda mod: [mod.max_cholesky_size(0), mod.eval_cg_tolerance(1e-10), mod.cg_tolerance(1e-10),
                             mod.max_cg_iterations(2000), mod.fast_pred_var(True),
                             mod.max_root_decomposition_size(60), mod.max_preconditioner_size(0)]) if love else (
        lambda mod: [])
    start = np.random.default_rng(9).normal(size=(b, n, 20))

    def enter(stack, mod):
        for ctx in settings(mod):
            stack.enter_context(ctx)

    import contextlib

    import gpytorch_tpu.solvers.lanczos
    import gpytorch_tpu_torch.solvers.lanczos

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpytorch_tpu.solvers.lanczos, "_block_init", lambda linop, iv, bs: jnp.asarray(start[..., :bs]))
        mp.setattr(gpytorch_tpu_torch.solvers.lanczos, "_block_init",
                   lambda linop, iv, bs: torch.from_numpy(start[..., :bs]))

        @jax.jit
        def posterior(p, z):
            with contextlib.ExitStack() as stack:
                enter(stack, gp.settings)
                post = jm.with_params(p).eval()(z)
                return post.mean, post.variance

        want_mean, want_var = (np.asarray(a) for a in posterior(jp, jnp.broadcast_to(jnp.asarray(test), (b, q, 1))))
        tm = _batch_kiss_model(gt, torch.from_numpy(x[:n]).expand(b, n, 1), torch.from_numpy(y[:, :n])).double()
        tm = gt.load_jax_params(tm, {**params, **_grid_state(jm.covar_module, "covar_module.")})
        assert tm.covar_module(tm.train_inputs[0]).evaluate_kernel().shape == (b, n, n)
        tm.eval()
        with contextlib.ExitStack() as stack, torch.no_grad():
            enter(stack, gt.settings)
            post = tm(torch.from_numpy(test))
    assert post.mean.shape == (b, q)
    np.testing.assert_allclose(post.mean.numpy(), want_mean, rtol=1e-8, atol=1e-8 * np.abs(want_mean).max())
    np.testing.assert_allclose(post.variance.numpy(), want_var, rtol=1e-8, atol=1e-8 * want_var.max())
