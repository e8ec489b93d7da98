"""The port's solvers (gpytorch_tpu_torch/solvers) against the JAX package's, in float64 on
the CPU, on the same numpy inputs: pivoted Cholesky, preconditioned CG and the block
Lanczos inverse root."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt
from gpytorch_tpu.solvers.cg import linear_cg as jax_linear_cg
from gpytorch_tpu.solvers.lanczos import _block_plan as jax_block_plan
from gpytorch_tpu.solvers.lanczos import lanczos_inv_root as jax_lanczos_inv_root
from gpytorch_tpu.solvers.pivoted_cholesky import pivoted_cholesky as jax_pivoted_cholesky
from gpytorch_tpu_torch.solvers import lanczos_inv_root, linear_cg, pivoted_cholesky


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _kernel_matrix(n, seed, lengthscale=0.3):
    x = np.random.default_rng(seed).uniform(size=(n, 3))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return 1.3 * np.exp(-0.5 * d2 / lengthscale**2)


def _both(settings_kw):
    """Enter the same settings in both packages."""
    stack = contextlib.ExitStack()
    for mod in (gp.settings, gt.settings):
        for name, value in settings_kw.items():
            stack.enter_context(getattr(mod, name)(value))
    return stack


@pytest.mark.parametrize("rank,rel_tol", [(15, 0.0), (40, 1e-3), (80, 0.0)])
def test_pivoted_cholesky(rank, rel_tol):
    K = _kernel_matrix(120, seed=0)
    L_j, piv_j = jax_pivoted_cholesky(gp.linop.DenseLinearOperator(jnp.asarray(K)), rank, rel_tol=rel_tol, return_pivots=True)
    L_t, piv_t = pivoted_cholesky(gt.linop.DenseLinearOperator(torch.from_numpy(K)), rank, rel_tol=rel_tol, return_pivots=True)
    np.testing.assert_array_equal(piv_t.numpy(), np.asarray(piv_j))
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=0, atol=1e-10)


def test_pivoted_cholesky_on_given_pivots():
    K = torch.from_numpy(_kernel_matrix(120, seed=0))
    op = gt.linop.DenseLinearOperator(K)
    L, piv = pivoted_cholesky(op, 15, return_pivots=True)
    L_same, piv_same = pivoted_cholesky(op, 15, return_pivots=True, pivots=piv)
    assert torch.equal(piv_same, piv) and torch.equal(L_same, L)
    # another order: the factor still reproduces K on the rows and columns it pivoted on
    order = torch.arange(0, 120, 8)
    L_o, piv_o = pivoted_cholesky(op, 15, return_pivots=True, pivots=order)
    assert torch.equal(piv_o, order)
    torch.testing.assert_close((L_o @ L_o.mT)[order][:, order], K[order][:, order], rtol=0, atol=1e-10)


@pytest.mark.parametrize("budget", [0.0, 1e-3])
@pytest.mark.parametrize("t", [1, 3])
def test_preconditioned_cg(budget, t):
    # A system that the preconditioned iteration solves in a few tens of steps: CG run in
    # another summation order drifts away exponentially once orthogonality is lost, so
    # the two packages agree to round-off only while the solve is short.
    n, noise, tol = 300, 0.1, 1e-4
    K = _kernel_matrix(n, seed=1)
    rhs = np.random.default_rng(2).normal(size=(n, t))
    settings_kw = dict(min_preconditioning_size=0, max_preconditioner_size=30, preconditioner_noise_budget=budget,
                       cg_stall_window=50)
    with _both(settings_kw):
        op_j = gp.linop.DenseLinearOperator(jnp.asarray(K)).add_diagonal(jnp.asarray(noise))
        res_j = jax_linear_cg(op_j._matmul, jnp.asarray(rhs), precond_fn=op_j._preconditioner()[0], tolerance=tol)
        op_t = gt.linop.DenseLinearOperator(torch.from_numpy(K)).add_diagonal(torch.tensor(noise, dtype=torch.float64))
        res_t = linear_cg(op_t._matmul, torch.from_numpy(rhs), precond_fn=op_t._preconditioner()[0], tolerance=tol)
    assert res_t.num_iters == int(res_j.num_iters)
    np.testing.assert_allclose(res_t.solution.numpy(), np.asarray(res_j.solution), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(res_t.residual_norm.numpy(), np.asarray(res_j.residual_norm), rtol=1e-6)
    # and each column is solved to the tolerance
    x = res_t.solution.numpy()
    resid = np.linalg.norm((K + noise * np.eye(n)) @ x - rhs, axis=0) / np.linalg.norm(rhs, axis=0)
    assert (resid < tol).all()


def test_cg_stops_on_the_stall_window():
    # no preconditioner and an unreachable tolerance: CG stops once no column improves
    n = 200
    K = _kernel_matrix(n, seed=3) + 1e-6 * np.eye(n)
    rhs = np.random.default_rng(4).normal(size=(n, 2))
    with _both(dict(cg_stall_window=5)):
        res_j = jax_linear_cg(lambda v: jnp.asarray(K) @ v, jnp.asarray(rhs), tolerance=1e-30, max_iter=400)
        res_t = linear_cg(lambda v: torch.from_numpy(K) @ v, torch.from_numpy(rhs), tolerance=1e-30, max_iter=400)
    assert res_t.num_iters == int(res_j.num_iters) < 400
    np.testing.assert_allclose(res_t.solution.numpy(), np.asarray(res_j.solution), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("max_rank", [30, 100])
def test_lanczos_inv_root_with_injected_start(max_rank):
    n, noise = 200, 0.05
    K = _kernel_matrix(n, seed=5)
    b, _ = jax_block_plan(max_rank, n)
    block = np.random.default_rng(6).normal(size=(n, b))
    op_j = gp.linop.DenseLinearOperator(jnp.asarray(K)).add_diagonal(jnp.asarray(noise))
    op_t = gt.linop.DenseLinearOperator(torch.from_numpy(K)).add_diagonal(torch.tensor(noise, dtype=torch.float64))
    R_j = np.asarray(jax_lanczos_inv_root(op_j, max_rank, initial_vectors=jnp.asarray(block)))
    R_t = lanczos_inv_root(op_t, max_rank, initial_vectors=torch.from_numpy(block)).numpy()
    assert R_t.shape == R_j.shape == (n, max_rank)
    # R is defined up to the signs of its columns: compare R Rᵀ ≈ (K + σ²I)⁻¹
    np.testing.assert_allclose(R_t @ R_t.T, R_j @ R_j.T, rtol=0, atol=1e-10 * np.abs(R_j @ R_j.T).max())


def test_default_lanczos_start_is_the_same_in_every_precision():
    from gpytorch_tpu_torch.solvers.lanczos import _block_init

    K = torch.from_numpy(_kernel_matrix(50, seed=7))
    blocks = [_block_init(gt.linop.DenseLinearOperator(K.to(dt)), None, 6) for dt in (torch.float64, torch.float32)]
    assert blocks[1].dtype == torch.float32
    torch.testing.assert_close(blocks[1].double(), blocks[0], rtol=1e-7, atol=0)


# ---------------------------------------------------------------------------------------
# the training solve: mBCG options, tridiagonals, the Nyström factor and log|P|
# ---------------------------------------------------------------------------------------

def _training_system(n=300, noise=0.1, t_probes=4, seed=8):
    K = _kernel_matrix(n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    rhs = rng.normal(size=(n, 1 + t_probes))
    x0 = np.linalg.solve(K + noise * np.eye(n), rhs[:, :1]) + 0.01 * rng.normal(size=(n, 1))
    return K, noise, rhs, x0


@pytest.mark.parametrize("mode", ["cold", "warm", "lagged", "lagged_from_zero"])
def test_linear_cg_training_options(mode):
    # n_tridiag_iter with its α/β, and the warm rhs column gating the stop (conv_cols),
    # plain or lagged; "lagged_from_zero" is the first training step, whose warm state is
    # zeros: its forced α = 1 is a no-op and costs one iteration, as in the JAX package
    K, noise, rhs, x0 = _training_system()
    x0 = {"cold": None, "warm": x0, "lagged": x0, "lagged_from_zero": np.zeros_like(x0)}[mode]
    kw = dict(n_tridiag_iter=6, tolerance=0.01)
    if x0 is not None:
        x0 = np.concatenate([x0, np.zeros((K.shape[0], rhs.shape[1] - 1))], axis=1)
        kw.update(conv_cols=1, lagged_rhs_init=mode.startswith("lagged"))
    settings_kw = dict(min_preconditioning_size=0, max_preconditioner_size=20, cg_stall_window=15)
    with _both(settings_kw):
        op_j = gp.linop.DenseLinearOperator(jnp.asarray(K)).add_diagonal(jnp.asarray(noise))
        op_t = gt.linop.DenseLinearOperator(torch.from_numpy(K)).add_diagonal(torch.tensor(noise, dtype=torch.float64))
        pc_j, pc_t = op_j._preconditioner()[0], op_t._preconditioner()[0]
        res_j = jax_linear_cg(op_j._matmul, jnp.asarray(rhs), precond_fn=pc_j,
                              x0=None if x0 is None else jnp.asarray(x0), **kw)
        res_t = linear_cg(op_t._matmul, torch.from_numpy(rhs), precond_fn=pc_t,
                          x0=None if x0 is None else torch.from_numpy(x0), **kw)
    assert res_t.num_iters == int(res_j.num_iters) >= 6
    np.testing.assert_allclose(res_t.solution.numpy(), np.asarray(res_j.solution), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(res_t.alphas.numpy(), np.asarray(res_j.alphas), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(res_t.betas.numpy(), np.asarray(res_j.betas), rtol=1e-8, atol=1e-12)


def test_tridiag_from_coeffs():
    from gpytorch_tpu.solvers.cg import tridiag_from_coeffs as jax_tridiag

    rng = np.random.default_rng(9)
    alphas, betas = rng.uniform(0.2, 2.0, size=(6, 5)), rng.uniform(0.0, 1.0, size=(6, 5))
    betas[2, 1] = -1e-3  # a negative β (a dead column) gives a zero off-diagonal in both
    T = gt.solvers.tridiag_from_coeffs(torch.from_numpy(alphas), torch.from_numpy(betas))
    assert T.shape == (5, 6, 6)
    np.testing.assert_allclose(T.numpy(), np.asarray(jax_tridiag(jnp.asarray(alphas), jnp.asarray(betas))), rtol=1e-14, atol=0)


def test_nystrom_factor_from_pivots():
    from gpytorch_tpu.solvers.pivoted_cholesky import nystrom_factor_from_pivots as jax_nystrom

    K = _kernel_matrix(150, seed=10)
    _, piv = pivoted_cholesky(gt.linop.DenseLinearOperator(torch.from_numpy(K)), 12, return_pivots=True)
    L_j = np.asarray(jax_nystrom(gp.linop.DenseLinearOperator(jnp.asarray(K)), jnp.asarray(piv.numpy())))
    L_t = gt.solvers.nystrom_factor_from_pivots(gt.linop.DenseLinearOperator(torch.from_numpy(K)), piv)
    np.testing.assert_allclose(L_t.numpy(), L_j, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("fast", [True, False])
def test_preconditioner_logdet_and_gradient(fast):
    # log|P| of the τ-regularised rank-20 preconditioner of θ·K₀ + s·I, and its gradient
    # w.r.t. (θ, s): through the fixed-pivot Nyström factor (fast_precond_grad), or
    # through the pivoted-Cholesky loop itself
    K0 = _kernel_matrix(200, seed=11)
    theta, s = 1.3, 0.05
    settings_kw = dict(min_preconditioning_size=0, max_preconditioner_size=20, preconditioner_noise_budget=1e-3,
                       fast_precond_grad=fast)

    def jax_logdet(p):
        return gp.linop.DenseLinearOperator(p[0] * jnp.asarray(K0)).add_diagonal(p[1])._preconditioner()[2]

    with _both(settings_kw):
        val_j, grad_j = jax.jit(jax.value_and_grad(jax_logdet))(jnp.asarray([theta, s]))
        p = torch.tensor([theta, s], dtype=torch.float64, requires_grad=True)
        val_t = gt.linop.DenseLinearOperator(p[0] * torch.from_numpy(K0)).add_diagonal(p[1])._preconditioner()[2]
        val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-10)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad_j), rtol=1e-8)


# ---------------------------------------------------------------------------------------
# iterative refinement of the CG solve (settings.solve_iterative_refinements)
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("passes", [1, 2])
def test_refined_solve_matches_jax_package(passes):
    # x ← x + CG(A, b − A x), each pass a short preconditioned solve as in
    # test_preconditioned_cg, so that both packages take the same iterations
    from gpytorch_tpu.solvers.cg import linear_solve_cg as jax_linear_solve_cg

    n, noise, tol = 300, 0.1, 1e-2
    K = _kernel_matrix(n, seed=1)
    rhs = np.random.default_rng(2).normal(size=(n, 2))
    settings_kw = dict(min_preconditioning_size=0, max_preconditioner_size=30, preconditioner_noise_budget=1e-3,
                       cg_stall_window=50, cg_tolerance=tol)
    with _both(settings_kw):
        op_j = gp.linop.DenseLinearOperator(jnp.asarray(K)).add_diagonal(jnp.asarray(noise))
        op_t = gt.linop.DenseLinearOperator(torch.from_numpy(K)).add_diagonal(torch.tensor(noise, dtype=torch.float64))
        once_t = gt.solvers.linear_solve_cg(op_t, torch.from_numpy(rhs))
        with _both(dict(solve_iterative_refinements=passes)):
            x_j = np.asarray(jax_linear_solve_cg(op_j, jnp.asarray(rhs)))
            res_t = gt.solvers.linear_solve_cg(op_t, torch.from_numpy(rhs))
    np.testing.assert_allclose(res_t.solution.numpy(), x_j, rtol=1e-8, atol=1e-8 * np.abs(x_j).max())
    A = K + noise * np.eye(n)

    def resid(x):
        return np.linalg.norm(A @ x - rhs, axis=0) / np.linalg.norm(rhs, axis=0)

    # each pass shrinks the true residual, which the result's residual estimates
    assert (resid(res_t.solution.numpy()) < 0.5 * tol ** passes).all()
    assert (resid(res_t.solution.numpy()) < resid(once_t.solution.numpy())).all()
    assert res_t.num_iters > once_t.num_iters
    np.testing.assert_allclose(res_t.residual_norm.numpy(), resid(res_t.solution.numpy()), rtol=1e-3)


def test_refined_mean_cache_matches_jax_package(monkeypatch):
    # the flagship model's mean cache (K + σ²I)⁻¹(y − μ) at N=300 under the serving
    # settings and two passes of refinement, through both packages' models
    import sys

    from gpytorch_tpu.models import ExactGP as JaxExactGP

    n, d = 300, 3
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(n, d))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.1 * rng.normal(size=n)
    y = (y - y.mean()) / y.std()
    params = {"covar_module.base_kernel.raw_lengthscale": np.array([[-1.0, -0.5, -1.2]]),
              "covar_module.raw_outputscale": np.array(0.3), "likelihood.noise_covar.raw_noise": np.array([-3.5]),
              "mean_module.raw_constant": np.array(0.05)}
    serving = dict(max_cholesky_size=0, min_preconditioning_size=0, max_preconditioner_size=50,
                   preconditioner_noise_budget=1e-3, eval_cg_tolerance=1e-3, cg_stall_window=50,
                   solve_iterative_refinements=2)

    def sq_dist64(x1, x2, x1_eq_x2=False):
        # gpytorch_tpu's sq_dist forms its distance product in float32 even under x64
        adj = jnp.mean(x1, axis=-2, keepdims=True)
        x1, x2 = x1 - adj, x2 - adj
        res = (-2.0 * jnp.matmul(x1, x2.T, precision=jax.lax.Precision.HIGHEST) + jnp.sum(x1 * x1, -1, keepdims=True)
               + jnp.sum(x2 * x2, -1, keepdims=True).T)
        return jnp.maximum(res * (1.0 - jnp.eye(res.shape[-1])) if x1_eq_x2 else res, 0.0)

    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", sq_dist64)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", sq_dist64)

    class JaxModel(JaxExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gp.means.ConstantMean()
            self.covar_module = gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=d))

        def forward(self, x):
            return gp.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    class TorchModel(gt.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=d))

        def forward(self, x):
            return gt.distributions.MultivariateNormal(self.mean_module(x), self.covar_module(x))

    @jax.jit
    def jax_cache(p):
        jm = JaxModel(jnp.asarray(x), jnp.asarray(y), gp.likelihoods.GaussianLikelihood()).with_params(p).eval()
        with _settings_of(gp, serving):
            jm(jnp.asarray(x[:5]))
            return jm._cache["prediction_strategy"].mean_cache

    want = np.asarray(jax_cache({k: jnp.asarray(v) for k, v in params.items()}))
    tm = TorchModel(torch.from_numpy(x), torch.from_numpy(y), gt.likelihoods.GaussianLikelihood()).double()
    gt.load_jax_params(tm, params).eval()
    with _settings_of(gt, serving):
        strategy = tm.refresh()
    got = strategy.mean_cache.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8 * np.abs(want).max())
    assert strategy.lik_train_train_covar.last_cg_result.num_iters > 0


def _settings_of(package, settings_kw):
    """Enter the settings in one package."""
    stack = contextlib.ExitStack()
    for name, value in settings_kw.items():
        stack.enter_context(getattr(package.settings, name)(value))
    return stack


def test_refinement_counts_one_product_a_pass(monkeypatch):
    # float32, N=600 (every product streams): a pass is one residual product and the
    # iterations of its correction solve, as chip_smoke.py gates the launches on the card
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    calls = []
    plain = fk.fused_kernel_matvec

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(fk, "fused_kernel_matvec", counted)
    n = 600
    x = torch.from_numpy(np.random.default_rng(3).uniform(size=(n, 3))).float()
    kernel = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=3))
    kernel.base_kernel.lengthscale = 0.3
    noise = torch.tensor([0.02])
    op = (kernel(x) + gt.linop.ConstantDiagLinearOperator(noise, n)).evaluate_kernel()
    rhs = torch.from_numpy(np.random.default_rng(4).normal(size=(n, 1))).float()
    results = {}
    with torch.no_grad(), gt.settings.cg_tolerance(1e-3), gt.settings.cg_stall_window(50):
        for passes in (0, 2):
            calls.clear()
            with gt.settings.solve_iterative_refinements(passes):
                results[passes] = gt.solvers.linear_solve_cg(op, rhs)
            assert len(calls) == results[passes].num_iters + passes
    K = op.to_dense().double()

    def true_resid(res):
        return ((K @ res.solution.double() - rhs.double()).norm() / rhs.double().norm()).item()

    assert true_resid(results[2]) < true_resid(results[0])
