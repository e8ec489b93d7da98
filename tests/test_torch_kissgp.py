"""KISS-GP (SKI) and WISKI in the port against the JAX package, in float64 on the CPU.

Interpolation (Keys' cubic, a = −0.5, clamped at the grid's edges, first dimension
fastest), the grid utilities, the sparse products W· and Wᵀ· (a deterministic segment
sum), the Toeplitz and Kronecker operators, the interpolated operator's reads that form no
n × n or m × m matrix (``_diagonal``, ``_get_rows``) against its ``to_dense``, the KISS-GP
marginal log likelihood and its gradient by mBCG with injected probes, the posterior (mean,
LOVE variance and sample root, and the exact branch), WISKI fantasy updates, and
``load_jax_params`` carrying the grid.  The model is ConstantMean +
GridInterpolationKernel(ScaleKernel(RBF)) + GaussianLikelihood, as in the JAX package's
``tests/test_scalable_gp_regression.py`` and ``examples/02_scalable_kissgp_love.py``.

The JAX side runs under ``jax.jit`` with its float32 distance product swapped for a
float64 one.  A JAX grid kernel refits a dynamic grid only eagerly (under a trace it keeps
its grid), so its grid is fitted eagerly first and carried into the port by
``load_jax_params``.  Tolerances are stated where they are used: 1e-12 for interpolation
and exact closed forms, 1e-9 of the largest entry for results of CG, Lanczos and
eigendecompositions (the same arithmetic in another order).
"""

import contextlib
import functools
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu.linop.root
import gpytorch_tpu.solvers.lanczos
import gpytorch_tpu_torch as gt
import gpytorch_tpu_torch.solvers.lanczos
from gpytorch_tpu.models import ExactGP as JaxExactGP
from gpytorch_tpu.utils import grid as jgrid
from gpytorch_tpu.utils import interpolation as jinterp
from gpytorch_tpu_torch.ops import interp as tinterp
from gpytorch_tpu_torch.utils import grid as tgrid
from gpytorch_tpu_torch.utils import interpolation as tinterpolation

PARAMS = {
    "covar_module.base_kernel.base_kernel.raw_lengthscale": np.array([[-1.6]]),
    "covar_module.base_kernel.raw_outputscale": np.array(0.4),
    "likelihood.noise_covar.raw_noise": np.array([-4.0]),
    "mean_module.raw_constant": np.array(0.05),
}
TIGHT = 1e-12
RTOL = 1e-9


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


def _start_block(n, b):
    return np.random.default_rng([9, n, b]).normal(size=(n, b))


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    """Float64 distances in JAX, and the Lanczos start blocks of both packages keyed by shape."""
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    monkeypatch.setattr(gpytorch_tpu.solvers.lanczos, "_block_init",
                        lambda linop, iv, b: jnp.asarray(_start_block(linop.shape[-1], b)))
    monkeypatch.setattr(gpytorch_tpu_torch.solvers.lanczos, "_block_init",
                        lambda linop, iv, b: torch.from_numpy(_start_block(linop.shape[-1], b)))


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


# -- interpolation and grids ---------------------------------------------------------------

@pytest.mark.parametrize("dims", [1, 2])
def test_interpolation_matches_jax_package(dims):
    # random points, points on grid nodes and points past both edges (clamped)
    sizes, bounds = [12, 9][:dims], [(0.0, 1.0), (-2.0, 3.0)][:dims]
    jg = jgrid.create_grid(sizes, bounds, dtype=jnp.float64)
    tg = tgrid.create_grid(sizes, bounds, dtype=torch.float64)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(b.numpy(), a)
    rng = np.random.default_rng(dims)
    lo, hi = np.array([g[0] for g in jg]), np.array([g[-1] for g in jg])
    x = np.concatenate([rng.uniform(lo, hi, size=(40, dims)),
                        np.stack([g[rng.integers(0, len(g), 10)] for g in jg], -1),
                        np.stack([lo - 0.3 * (hi - lo), hi + 0.2 * (hi - lo), lo, hi])])
    want_i, want_v = jax.jit(jinterp.Interpolation().interpolate)([jnp.asarray(g) for g in jg], jnp.asarray(x))
    got_i, got_v = tinterpolation.Interpolation().interpolate(tg, torch.from_numpy(x))
    assert got_i.shape == (len(x), 4 ** dims)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    _close(got_v, want_v, TIGHT)
    np.testing.assert_allclose(got_v.sum(-1).numpy(), 1.0, rtol=0, atol=TIGHT)
    # the cubic convolution reproduces a linear function on a full window (a point at
    # least one spacing inside the grid), and clamps points outside onto the edges
    grid_pts = tgrid.create_data_from_grid(tg)
    W = torch.zeros(len(x), len(grid_pts), dtype=torch.float64).scatter_add_(1, got_i, got_v)
    inner = np.all((x >= [g[1] for g in jg]) & (x <= [g[-2] for g in jg]), -1)
    np.testing.assert_allclose((W @ grid_pts).numpy()[inner], x[inner], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got_i.numpy()[-4], got_i.numpy()[-2])
    _close(got_v[-4], got_v[-2], TIGHT)


def test_grid_utilities_match_jax_package():
    x1, x2 = np.linspace(0, 1, 100_000), np.random.default_rng(0).uniform(size=(100_000, 2))
    for x in (x1, x2):
        for kron in (True, False):
            assert tgrid.choose_grid_size(torch.from_numpy(x), 1.5, kron) == jgrid.choose_grid_size(jnp.asarray(x), 1.5,
                                                                                                    kron)
    assert tgrid.choose_grid_size(torch.from_numpy(x2)) == 316
    for extend in (True, False):
        jg = jgrid.create_grid([7, 5, 4], [(0.0, 1.0), (-1.0, 2.0), (3.0, 4.5)], extend=extend, dtype=jnp.float32)
        tg = tgrid.create_grid([7, 5, 4], [(0.0, 1.0), (-1.0, 2.0), (3.0, 4.5)], extend=extend, dtype=torch.float32)
        for a, b in zip(jg, tg):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), a)
        np.testing.assert_array_equal(tgrid.create_data_from_grid(tg).numpy(), jgrid.create_data_from_grid(jg))
        legacy = tgrid.create_data_from_grid(tg)[:4]
        for a, b in zip(tgrid.convert_legacy_grid(legacy), jgrid.convert_legacy_grid(np.asarray(legacy))):
            np.testing.assert_array_equal(a.numpy(), b)
    jscale, tscale = jgrid.ScaleToBounds(-1.0, 1.0), tgrid.ScaleToBounds(-1.0, 1.0)
    z = np.random.default_rng(1).normal(size=(30, 2))
    _close(tscale(torch.from_numpy(z)), jscale(jnp.asarray(z)), TIGHT)
    tscale.eval()
    jscale.eval()
    _close(tscale(torch.from_numpy(z[:5] * 3)), jscale(jnp.asarray(z[:5] * 3)), TIGHT)


def test_sparse_products_match_jax_package_and_are_deterministic():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 30, size=(200, 4))
    idx[:50] = 7  # many rows on one grid point
    val, rhs_m, rhs_n = rng.normal(size=(200, 4)), rng.normal(size=(30, 3)), rng.normal(size=(200, 3))
    ti, tv = torch.from_numpy(idx), torch.from_numpy(val)
    _close(tinterp.left_interp(ti, tv, torch.from_numpy(rhs_m)),
           gp.ops.interp.left_interp(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(rhs_m)), TIGHT)
    want = gp.ops.interp.left_t_interp(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(rhs_n), 30)
    got = tinterp.left_t_interp(ti, tv, torch.from_numpy(rhs_n), 30)
    _close(got, want, TIGHT)
    assert torch.equal(got, tinterp.left_t_interp(ti, tv, torch.from_numpy(rhs_n), 30))
    _close(tinterp.left_t_interp(ti, tv, torch.from_numpy(rhs_n[:, 0]), 30), np.asarray(want)[:, 0], TIGHT)
    # the order of summation is the rows' order: a float32 sum equals the sequential one
    v32 = torch.from_numpy(val).float()
    r32 = torch.from_numpy(rhs_n).float()
    seq = torch.zeros(30, 3)
    for i in range(200):
        for q in range(4):
            seq[idx[i, q]] += v32[i, q] * r32[i]
    assert torch.equal(tinterp.left_t_interp(ti, v32, r32, 30), seq)


# -- structured operators -----------------------------------------------------------------

def _column(n, ls=0.3, seed=0):
    g = np.linspace(0, 1, n)
    return np.exp(-0.5 * (g - g[0]) ** 2 / ls**2) + (np.arange(n) == 0) * 5e-2


def test_toeplitz_matches_jax_package():
    col = _column(40)
    rhs = np.random.default_rng(3).normal(size=(40, 3))
    idx = np.array([0, 5, 39])

    @jax.jit
    def jax_side(c, r, i):
        op = gp.linop.ToeplitzLinearOperator(c)
        return op.to_dense(), op.matmul(r), op.matmul(r[:, 0]), op._diagonal(), op._get_rows(i), op.solve(r), op.logdet()

    want = jax_side(jnp.asarray(col), jnp.asarray(rhs), jnp.asarray(idx))
    top = gt.linop.ToeplitzLinearOperator(torch.from_numpy(col))
    r = torch.from_numpy(rhs)
    got = (top.to_dense(), top.matmul(r), top.matmul(r[:, 0]), top._diagonal(), top._get_rows(torch.from_numpy(idx)),
           top.solve(r), top.logdet())
    for g, w, tol in zip(got, want, (TIGHT, 1e-12, 1e-12, TIGHT, TIGHT, 1e-10, 1e-10)):
        _close(g, w, tol)
    # the column's gradient through the FFT product against the dense product's
    c = torch.from_numpy(col).requires_grad_(True)
    u, v = r[:, :1], r[:, 1:2]
    (u.mT @ gt.linop.ToeplitzLinearOperator(c).matmul(v)).sum().backward()
    g_fft = c.grad.clone()
    c.grad = None
    (u.mT @ gt.linop.ToeplitzLinearOperator(c).to_dense() @ v).sum().backward()
    torch.testing.assert_close(g_fft, c.grad, rtol=1e-10, atol=1e-10)


def _kron_ops(pkg, kind, a, b):
    """The operator of ``kind`` in the package ``pkg`` (``gp`` or ``gt``) from arrays a, b."""
    if kind == "kron_diag":
        return pkg.linop.KroneckerProductDiagLinearOperator(pkg.linop.DiagLinearOperator(a),
                                                            pkg.linop.DiagLinearOperator(b))
    dense_b = pkg.linop.ToeplitzLinearOperator(b).to_dense()
    op = pkg.linop.KroneckerProductLinearOperator(pkg.linop.ToeplitzLinearOperator(a),
                                                  pkg.linop.DenseLinearOperator(dense_b))
    return op.add_diagonal(a[:1] * 0 + 0.05) if kind == "kron_added_diag" else op


@pytest.mark.parametrize("kind", ["kron", "kron_diag", "kron_added_diag"])
def test_kronecker_operators_match_jax_package(kind):
    if kind == "kron_diag":
        a, b = np.exp(np.linspace(-1, 1, 5)), np.exp(np.linspace(0, 2, 4))
    else:
        a, b = _column(5, 0.4), _column(4, 0.7)
    rhs = np.random.default_rng(4).normal(size=(20, 3))

    def outputs(op, r):
        iq, ld = op.inv_quad_logdet(r, logdet=True)
        return op.to_dense(), op.matmul(r), op._diagonal(), op.solve(r), op.logdet(), iq, ld

    want = jax.jit(lambda a_, b_, r: outputs(_kron_ops(gp, kind, a_, b_), r))(jnp.asarray(a), jnp.asarray(b),
                                                                               jnp.asarray(rhs))
    top = _kron_ops(gt, kind, torch.from_numpy(a), torch.from_numpy(b))
    if kind == "kron_added_diag":
        assert isinstance(top, gt.linop.KroneckerProductAddedDiagLinearOperator)
    got = outputs(top, torch.from_numpy(rhs))
    for g, w, tol in zip(got, want, (TIGHT, 1e-12, TIGHT, 1e-10, 1e-10, 1e-10, 1e-10)):
        _close(g, w, tol)
    # against a dense solve: 1e-6, the factors' Cholesky jitter (1e-8) over their scale
    _close(got[3], np.linalg.solve(np.asarray(want[0]), rhs), 1e-6)


def _interp_base(pkg, base, cols):
    if base == "kronecker":
        return pkg.linop.KroneckerProductLinearOperator(*[pkg.linop.ToeplitzLinearOperator(c) for c in cols[::-1]])
    op = pkg.linop.ToeplitzLinearOperator(cols[0])
    return pkg.linop.DenseLinearOperator(op.to_dense()) if base == "dense" else op


@pytest.mark.parametrize("base", ["toeplitz", "kronecker", "dense"])
def test_interpolated_reads_match_to_dense_and_jax_package(base):
    # _diagonal (q × q entries of K_UU) and _get_rows (one product with K_UU) form no n × n
    # or m × m matrix; both against to_dense, and to_dense against the JAX package's
    if base == "kronecker":
        sizes, bounds, cols = [9, 7], [(0.0, 1.0), (0.0, 2.0)], [_column(9, 0.3), _column(7, 0.5)]
    else:
        sizes, bounds, cols = [25], [(0.0, 1.0)], [_column(25, 0.2)]
    rng = np.random.default_rng(5)
    grid = tgrid.create_grid(sizes, bounds, dtype=torch.float64)
    xl, xr = rng.uniform(size=(30, len(sizes))) * [b[1] for b in bounds], rng.uniform(size=(22, len(sizes)))
    li, lv = tinterpolation.Interpolation().interpolate(grid, torch.from_numpy(xl))
    ri, rv = tinterpolation.Interpolation().interpolate(grid, torch.from_numpy(xr))

    @jax.jit
    def jax_side(cs, li_, lv_, ri_, rv_):
        jbase = _interp_base(gp, base, cs)
        return (gp.linop.InterpolatedLinearOperator(jbase, li_, lv_, ri_, rv_).to_dense(),
                gp.linop.InterpolatedLinearOperator(jbase, li_, lv_).to_dense())

    want, want_sym = jax_side([jnp.asarray(c) for c in cols], *(jnp.asarray(t.numpy()) for t in (li, lv, ri, rv)))
    tbase = _interp_base(gt, base, [torch.from_numpy(c) for c in cols])
    top = gt.linop.InterpolatedLinearOperator(tbase, li, lv, ri, rv)
    dense = top.to_dense()
    _close(dense, want, 1e-12)
    _close(top[slice(3, 11), slice(0, 30)].to_dense(), np.asarray(want)[3:11, 0:22], 1e-12)
    _close(top.matmul(torch.eye(22, dtype=torch.float64)), dense, 1e-12)
    sym = gt.linop.InterpolatedLinearOperator(tbase, li, lv)
    sym_dense = sym.to_dense()
    _close(sym_dense, want_sym, 1e-12)
    _close(sym._diagonal(), torch.diagonal(sym_dense), 1e-12)
    rows = torch.tensor([0, 7, 29, 7])
    _close(top._get_rows(rows), dense[rows], 1e-12)
    _close(sym._get_rows(rows), sym_dense[rows], 1e-12)


# -- the KISS-GP model -------------------------------------------------------------------

N, M, GRID = 300, 40, 100


class JaxKiss(JaxExactGP):
    def __init__(self, x, y, likelihood, grid_size=GRID, num_dims=1, grid_bounds=None):
        super().__init__(x, y, likelihood)
        self.mean_module = gp.means.ConstantMean()
        self.covar_module = gp.kernels.GridInterpolationKernel(
            gp.kernels.ScaleKernel(gp.kernels.RBFKernel()), grid_size=grid_size, num_dims=num_dims,
            grid_bounds=grid_bounds)

    def forward(self, x):
        return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


class TorchKiss(gt.models.ExactGP):
    def __init__(self, x, y, likelihood, grid_size=GRID, num_dims=1, grid_bounds=None):
        super().__init__(x, y, likelihood)
        self.mean_module = gt.means.ConstantMean()
        self.covar_module = gt.kernels.GridInterpolationKernel(
            gt.kernels.ScaleKernel(gt.kernels.RBFKernel()), grid_size=grid_size, num_dims=num_dims,
            grid_bounds=grid_bounds)

    def forward(self, x):
        return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))


def _task(dims=1, n=N, m=M, seed=0):
    # test points inside the training inputs' range: a dynamic grid refits to inputs that
    # leave it, which the JAX package does eagerly only, never under jax.jit
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, dims))
    y = np.sin(6 * x[:, 0]) + (0.5 * np.cos(4 * x[:, 1]) if dims > 1 else 0.0) + 0.1 * rng.normal(size=n)
    return x, y, rng.uniform(0.05, 0.95, size=(m, dims))


def _grid_state(kernel):
    return {"covar_module.grid": [np.asarray(g) for g in kernel.grid],
            "covar_module.grid_bounds": np.asarray(kernel.grid_bounds),
            "covar_module.has_initialized_grid": np.asarray(kernel.has_initialized_grid)}


@functools.lru_cache(maxsize=None)
def _jax_model(dims, grid_size, grid_bounds):
    """The JAX model with its grid fitted eagerly (its grid state rides along into every
    ``with_params`` copy)."""
    x, y, _ = _task(dims)
    jm = JaxKiss(jnp.asarray(x), jnp.asarray(y), gp.likelihoods.GaussianLikelihood(), grid_size, dims, grid_bounds)
    jm.covar_module(jnp.asarray(x)).evaluate_kernel()
    return jm


def _models(dims=1, grid_size=GRID, grid_bounds=None):
    """The JAX model, and the port's with the same parameters and grid."""
    x, y, _ = _task(dims)
    jm = _jax_model(dims, grid_size, None if grid_bounds is None else tuple(tuple(b) for b in grid_bounds))
    tm = TorchKiss(torch.from_numpy(x), torch.from_numpy(y), gt.likelihoods.GaussianLikelihood(), grid_size, dims,
                   grid_bounds).double()
    gt.load_jax_params(tm, {**PARAMS, **_grid_state(jm.covar_module)})
    return jm, tm


PROBES = 6


def _probe(shape):
    return np.random.default_rng([21, *shape]).normal(size=shape)


_JAX_DRAWS = {}


def _train_settings(mod):
    stack = contextlib.ExitStack()
    for ctx in (mod.max_cholesky_size(0), mod.min_preconditioning_size(0), mod.max_preconditioner_size(10),
                mod.num_trace_samples(PROBES), mod.cg_tolerance(1e-2), mod.max_cg_iterations(400),
                mod.cg_stall_window(50), mod.max_lanczos_quadrature_iterations(10),
                mod.preconditioner_noise_budget(1e-3)):
        stack.enter_context(ctx)
    return stack


@pytest.mark.parametrize("dims", [1, 2])
def test_kissgp_mll_and_gradient_match_jax_package(dims, monkeypatch):
    # mBCG/SLQ on W K_UU Wᵀ + σ²I with a rank-10 pivoted-Cholesky preconditioner (the
    # port's rows and diagonal never densify; the JAX package's do) and injected probes.
    # In 2D (a 14 × 14 grid, so K_UU has rank ≤ 196 < N) the noise is 0.13: at 0.018 the
    # two packages' float64 CG and SLQ read 1e-6 apart, summation-order differences
    # amplified by the conditioning, and 1e-9 apart at 0.13 and above.
    monkeypatch.setattr(gpytorch_tpu.linop.root, "probe_base_samples",
                        lambda key, shape, dtype: _JAX_DRAWS["draws"][tuple(shape)].astype(dtype))
    grid_size = GRID if dims == 1 else 14
    if dims == 2:
        monkeypatch.setitem(PARAMS, "likelihood.noise_covar.raw_noise", np.array([-2.0]))
    jm, tm = _models(dims, grid_size)
    x, y, _ = _task(dims)
    shapes = ((PROBES, 10, 1), (PROBES, N))

    def loss(p, draws):
        _JAX_DRAWS["draws"] = draws
        m = jm.with_params(p)
        with _train_settings(gp.settings):
            return -gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(jnp.asarray(x)), jnp.asarray(y),
                                                                         key=jax.random.PRNGKey(0))

    jl, jg = jax.jit(jax.value_and_grad(loss))({k: jnp.asarray(v) for k, v in PARAMS.items()},
                                                {s: jnp.asarray(_probe(s)) for s in shapes})
    tm.train()
    with _train_settings(gt.settings):
        tl = -gt.mlls.ExactMarginalLogLikelihood(tm.likelihood, tm)(tm(torch.from_numpy(x)), torch.from_numpy(y),
                                                                      base_samples=_probe)
    tl.backward()
    _close(tl, jl)
    for name, p in tm.named_parameters():
        _close(p.grad, jg[name], 1e-8)


def _serving_settings(mod):
    """CG and Lanczos caches at N=300, preconditioned so that CG ends in a few iterations
    (unpreconditioned, its hundreds of float64 iterations amplify the two packages'
    summation orders to 1e-6)."""
    stack = contextlib.ExitStack()
    for ctx in (mod.max_cholesky_size(0), mod.min_preconditioning_size(0), mod.max_preconditioner_size(50),
                mod.preconditioner_noise_budget(1e-3), mod.eval_cg_tolerance(1e-11), mod.cg_stall_window(50)):
        stack.enter_context(ctx)
    return stack


@pytest.mark.parametrize("mode", ["exact", "fast_pred_var", "fast_pred_samples"])
def test_kissgp_posterior_matches_jax_package(mode):
    # the mean from the inducing-space cache, and the covariance: exact, LOVE, or the root
    # S of the test-independent sample cache (W* S)(W* S)ᵀ
    jm, tm = _models()
    _, _, tx = _task()
    flag = {"exact": contextlib.nullcontext, "fast_pred_var": gp.settings.fast_pred_var,
            "fast_pred_samples": gp.settings.fast_pred_samples}[mode]
    tflag = {"exact": contextlib.nullcontext, "fast_pred_var": gt.settings.fast_pred_var,
             "fast_pred_samples": gt.settings.fast_pred_samples}[mode]

    @jax.jit
    def posterior(params, test_x):
        with flag(), _serving_settings(gp.settings):
            post = jm.with_params(params).eval()(test_x)
            return post.mean, post.covariance_matrix

    want_mean, want_cov = posterior({k: jnp.asarray(v) for k, v in PARAMS.items()}, jnp.asarray(tx))
    tm.eval()
    with tflag(), _serving_settings(gt.settings), torch.no_grad():
        post = tm(torch.from_numpy(tx))
    strategy = tm._cache["prediction_strategy"]
    assert type(strategy).__name__ == "InterpolatedPredictionStrategy"
    _close(post.mean, want_mean)
    # the sample root spans K_UU − (K_UU Wᵀ R)(K_UU Wᵀ R)ᵀ at full rank, down to Ritz values
    # at the 1e-8 floor, where the two packages' Lanczos runs read 1e-7 apart
    _close(post.covariance_matrix, want_cov, 1e-6 if mode == "fast_pred_samples" else 1e-8)
    if mode == "fast_pred_samples":
        assert strategy._interp_sample_cache.shape == (GRID, 100)
        draws = post.rsample((8,), base_samples=torch.Generator().manual_seed(0))
        assert draws.shape == (8, M) and torch.isfinite(draws).all()


def test_kissgp_sine_reaches_the_reference_gate():
    # the JAX package's KISS-GP test (tests/test_scalable_gp_regression.py:64, the
    # reference's gate MAE < 0.05): 100 points of sin 2πx, a dynamic grid of 50, 60 Adam
    # steps at lr 0.1 on the default (Cholesky) path; then LOVE variances against the exact
    # ones at the reference's relative gate (0.1 there)
    train_x = torch.linspace(0, 1, 100, dtype=torch.float64)
    train_y = torch.sin(train_x * 2 * math.pi)
    test_x = torch.linspace(0.02, 0.98, 51, dtype=torch.float64)
    tm = TorchKiss(train_x, train_y, gt.likelihoods.GaussianLikelihood(), 50).double()
    mll = gt.mlls.ExactMarginalLogLikelihood(tm.likelihood, tm)
    opt = torch.optim.Adam(tm.parameters(), lr=0.1)
    tm.train()
    for _ in range(60):
        opt.zero_grad()
        loss = -mll(tm(train_x), train_y)
        loss.backward()
        opt.step()
    assert int(tm.covar_module.has_initialized_grid) == 1
    tm.eval()
    with torch.no_grad():
        post = tm(test_x)
        exact_var = post.variance
        tm.clear_caches()
        with gt.settings.fast_pred_var():
            love_var = tm(test_x).variance
    mae = (post.mean - torch.sin(test_x * 2 * math.pi)).abs().mean().item()
    assert mae < 0.05, mae
    assert ((love_var - exact_var).abs() / exact_var.clamp_min(1e-6)).max().item() < 0.1


def test_kissgp_at_scale_forms_no_square_matrix(monkeypatch):
    # training steps, the caches and a request at N=3,000 on a grid of 3,000 under
    # max_cholesky_size(0): nothing calls to_dense of the interpolated operator, whose
    # rows and diagonal read K_UU's entries
    def refuse(self):
        raise AssertionError(f"to_dense of a {self.shape} interpolated operator")

    monkeypatch.setattr(gt.linop.InterpolatedLinearOperator, "to_dense", refuse)
    n = 3000
    x = torch.linspace(0, 10, n, dtype=torch.float64)
    y = torch.sin(x) + 0.1 * torch.from_numpy(np.random.default_rng(0).normal(size=n))
    tm = TorchKiss(x, y, gt.likelihoods.GaussianLikelihood(), gt.utils.grid.choose_grid_size(x)).double()
    assert tm.covar_module.grid_sizes == (n,)
    opt = torch.optim.Adam(tm.parameters(), lr=0.1)
    tm.train()
    with gt.settings.max_cholesky_size(0), gt.settings.max_preconditioner_size(10), gt.settings.cg_tolerance(0.3):
        for _ in range(2):
            opt.zero_grad()
            loss = -gt.mlls.ExactMarginalLogLikelihood(tm.likelihood, tm)(tm(x), y,
                                                                            base_samples=torch.Generator().manual_seed(0))
            loss.backward()
            opt.step()
        tm.eval()
        with torch.no_grad(), gt.settings.fast_pred_var(), gt.settings.fast_pred_samples():
            tm.refresh()
            post = tm(torch.linspace(0.5, 9.5, 64, dtype=torch.float64))
            draws = post.rsample((4,), base_samples=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss) and torch.isfinite(draws).all()
    assert (post.variance > 0).all()


def test_wiski_fantasy_matches_jax_package():
    # a fantasy update promotes the KISS-GP strategy to WISKI (WᵀW, Wᵀr); a second update
    # adds the next points' terms; mean and variance against the JAX package, and the mean
    # against the KISS-GP model rebuilt on all the points
    bounds = [(-0.1, 1.1)]
    jm, tm = _models(grid_size=64, grid_bounds=bounds)
    _, _, tx = _task()
    rng = np.random.default_rng(8)
    xf = [rng.uniform(size=(6, 1)) for _ in range(2)]
    yf = [np.sin(6 * a[:, 0]) for a in xf]

    @jax.jit
    def fantasies(params):
        with gp.settings.eval_cg_tolerance(1e-11):
            m = jm.with_params(params).eval()
            m(jnp.asarray(tx))
            for a, b in zip(xf, yf):
                m = m.get_fantasy_model(jnp.asarray(a), jnp.asarray(b))
            post = m(jnp.asarray(tx))
            return post.mean, post.variance

    want_mean, want_var = fantasies({k: jnp.asarray(v) for k, v in PARAMS.items()})
    tm.eval()
    with torch.no_grad(), gt.settings.eval_cg_tolerance(1e-11):
        tm(torch.from_numpy(tx))
        fm = tm
        for a, b in zip(xf, yf):
            fm = fm.get_fantasy_model(torch.from_numpy(a), torch.from_numpy(b))
        post = fm(torch.from_numpy(tx))
        refit = TorchKiss(fm.train_inputs[0], fm.train_targets, gt.likelihoods.GaussianLikelihood(), 64, 1,
                          bounds).double()
        gt.load_jax_params(refit, {**PARAMS, **_grid_state(jm.covar_module)}).eval()
        ref_mean = refit(torch.from_numpy(tx)).mean
    assert type(fm._cache["prediction_strategy"]).__name__ == "WiskiPredictionStrategy"
    assert fm.train_inputs[0].shape == (N + 12, 1)
    _close(post.mean, want_mean, 1e-8)
    _close(post.variance, want_var, 1e-8)
    _close(post.mean, ref_mean.numpy(), 1e-6)


@pytest.mark.parametrize("grid", ["dynamic", "bounds"])
def test_load_jax_params_carries_the_grid(grid):
    # the JAX package keeps a grid made from bounds in float32 even under x64, and refits a
    # dynamic one in the inputs' dtype; the port takes both as they are, so that the two
    # interpolate on the same grid (the port also fits the same dynamic grid on its own)
    bounds = None if grid == "dynamic" else [(-0.2, 1.3)]
    jm, tm = _models(grid_bounds=bounds)
    jk, tk = jm.covar_module, tm.covar_module
    assert int(tk.has_initialized_grid) == 1
    assert tk.grid_0.dtype == (torch.float64 if grid == "dynamic" else torch.float32)
    np.testing.assert_array_equal(tk.grid_0.numpy(), np.asarray(jk.grid[0]))
    np.testing.assert_array_equal(tk.grid_bounds.numpy(), np.asarray(jk.grid_bounds))
    x = np.linspace(-0.1, 1.1, 57)[:, None]
    ji, jv = jax.jit(jk._compute_grid)(jnp.asarray(x))
    ti, tv = tk._compute_grid(torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv, jv, TIGHT)
    if grid == "dynamic":
        fresh = TorchKiss(tm.train_inputs[0], tm.train_targets, gt.likelihoods.GaussianLikelihood()).double()
        fresh.covar_module(tm.train_inputs[0]).evaluate_kernel()
        np.testing.assert_array_equal(fresh.covar_module.grid_0.numpy(), np.asarray(jk.grid[0]))
    with pytest.raises(KeyError, match="unknown"):
        gt.load_jax_params(tm, {**PARAMS, "covar_module.grid_shape": np.zeros(2)})


@pytest.mark.parametrize("dims", [1, 2])
def test_grid_kernel_matches_jax_package(dims):
    # GridKernel on its own grid: Toeplitz in 1D, a Kronecker product of Toeplitz factors
    # (first dimension fastest) in 2D, dense per-dimension factors without use_toeplitz; off
    # the grid, the base kernel's dense matrix; its diagonal the base kernel's
    sizes, bounds = [12, 7][:dims], [(0.0, 1.0), (-1.0, 2.0)][:dims]
    grid = jgrid.create_grid(sizes, bounds, dtype=jnp.float64)
    full = np.asarray(jgrid.create_data_from_grid(grid))
    off = np.random.default_rng(6).uniform(size=(9, dims))
    raw = np.array([[-0.3]])

    kernel = gp.kernels.GridKernel(gp.kernels.RBFKernel(), grid=grid)

    @jax.jit
    def jax_side(raw_ls, x_off):
        k = kernel.with_params({"base_kernel.raw_lengthscale": raw_ls})
        with gp.settings.lazily_evaluate_kernels(False):
            on = k(jnp.asarray(full)).to_dense()
            with gp.settings.use_toeplitz(False):
                dense = k(jnp.asarray(full)).to_dense()
            return on, dense, k(x_off, jnp.asarray(full)).to_dense(), k(jnp.asarray(full), diag=True)

    want = jax_side(jnp.asarray(raw), jnp.asarray(off))
    tk = gt.kernels.GridKernel(gt.kernels.RBFKernel(), grid=[torch.from_numpy(np.asarray(g)) for g in grid]).double()
    gt.load_jax_params(tk, {"base_kernel.raw_lengthscale": raw})
    x = torch.from_numpy(full)
    assert torch.equal(tgrid.create_data_from_grid(tk.grid), x)
    op = tk(x).evaluate_kernel()
    assert isinstance(op, gt.linop.ToeplitzLinearOperator if dims == 1 else gt.linop.KroneckerProductLinearOperator)
    with gt.settings.use_toeplitz(False):
        dense = tk(x).evaluate_kernel()
    got = (op.to_dense(), dense.to_dense(), tk(torch.from_numpy(off), x).to_dense(), tk(x, diag=True))
    for g, w in zip(got, want):
        _close(g, w, 1e-12)
