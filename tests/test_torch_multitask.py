"""The port's multitask operators, distributions and exact GPs against the JAX package, in
float64 on the CPU.

* ``BlockDiagLinearOperator`` and ``BlockInterleavedLinearOperator``: product, diagonal,
  solve and inv_quad_logdet;
* ``MultitaskMultivariateNormal`` in the interleaved and the block layout: mean, variance
  and log_prob;
* the Kronecker multitask GP of ``examples/03_multitask_gp.py`` (MultitaskMean,
  MultitaskKernel(RBFKernel) and MultitaskGaussianLikelihood): the MLL, its gradient in
  every raw parameter and the posterior mean and variances, at n=64 with 2 tasks (task
  noises; a task-noise factor of rank 1 without the global noise: the JAX package cannot
  take task noises without it) and with 3 tasks and a task-noise factor of rank 2, on the
  dense-Cholesky path (n·t ≤ max_cholesky_size) and by unpreconditioned mBCG (the sum
  K_data ⊗ K_task + I ⊗ Σ + σ²I has no preconditioner);
* LCMKernel (RBF and Matérn-3/2) and a Hadamard GP (RBF on the input column times an
  IndexKernel on the task column, HadamardGaussianLikelihood).

Both packages get the same numpy data and the JAX model's raw parameters through
``load_jax_params`` (their IndexKernel factors start from different random streams).  The
JAX side gets float64 distances and is ``jax.jit``ted.  Tolerance 1e-9 relative wherever
both run the same float64 arithmetic in another order.
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
import gpytorch_tpu_torch as gt

RTOL = 1e-9
N = 64


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


def _draw(shape):
    return np.random.default_rng([21, *shape]).normal(size=shape)


_JAX_DRAWS = {}


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    """Float64 distances in JAX, and the unpreconditioned probes injected, keyed by shape."""
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_dist_op", _exact_float64_dist)
    monkeypatch.setattr(gpytorch_tpu.linop.base, "probe_base_samples",
                        lambda key, shape, dtype: _JAX_DRAWS["draws"][tuple(shape)].astype(dtype))


def _jnp(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


# -- block operators -----------------------------------------------------------------------

def _blocks(b=3, n=20, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


@pytest.mark.parametrize("layout", ["block", "interleaved"])
def test_block_operators_match_jax_package(layout):
    # product, diagonal, solve and inv_quad_logdet of 3 blocks of 20 (dense Cholesky in
    # both packages); 1e-10 relative
    K = _blocks()
    jcls = gp.linop.BlockDiagLinearOperator if layout == "block" else gp.linop.BlockInterleavedLinearOperator
    tcls = gt.linop.BlockDiagLinearOperator if layout == "block" else gt.linop.BlockInterleavedLinearOperator
    jop, top = jcls(gp.linop.DenseLinearOperator(jnp.asarray(K))), tcls(gt.linop.DenseLinearOperator(torch.from_numpy(K)))
    rng = np.random.default_rng(1)
    v = rng.normal(size=(60, 4))
    np.testing.assert_allclose(top.to_dense().numpy(), np.asarray(jop.to_dense()), rtol=1e-12)
    np.testing.assert_allclose(top.matmul(torch.from_numpy(v)).numpy(), np.asarray(jop.matmul(jnp.asarray(v))), rtol=1e-10)
    np.testing.assert_allclose(top._diagonal().numpy(), np.asarray(jop._diagonal()), rtol=1e-12)
    np.testing.assert_allclose(top.solve(torch.from_numpy(v)).numpy(), np.asarray(jop.solve(jnp.asarray(v))), rtol=1e-10)
    tiq, tld = top.inv_quad_logdet(torch.from_numpy(v[:, :1]), logdet=True)
    jiq, jld = jop.inv_quad_logdet(jnp.asarray(v[:, :1]), logdet=True)
    np.testing.assert_allclose([tiq.item(), tld.item()], [float(jiq), float(jld)], rtol=1e-10)
    dense = top.to_dense().numpy()
    np.testing.assert_allclose(tld.item(), np.linalg.slogdet(dense)[1], rtol=1e-10)
    np.testing.assert_allclose(top.add_diagonal(torch.tensor(0.5, dtype=torch.float64)).to_dense().numpy(),
                               dense + 0.5 * np.eye(60), rtol=1e-12)


@pytest.mark.parametrize("interleaved", [True, False], ids=["interleaved", "block"])
def test_multitask_mvn_matches_jax_package(interleaved):
    # mean, variance and log_prob of a 2-task distribution over 20 points whose covariance
    # is dense in its own layout: the mean and variance come back as (n, t) in either
    # layout, and log_prob flattens its (n, t) argument the same way; 1e-10 relative
    rng = np.random.default_rng(2)
    mean = rng.normal(size=(20, 2))
    a = rng.normal(size=(40, 40))
    cov = a @ a.T + 40 * np.eye(40)
    value = rng.normal(size=(20, 2))
    jd = gp.distributions.MultitaskMultivariateNormal(jnp.asarray(mean), jnp.asarray(cov), interleaved=interleaved)
    td = gt.distributions.MultitaskMultivariateNormal(torch.from_numpy(mean), torch.from_numpy(cov),
                                                      interleaved=interleaved)
    np.testing.assert_allclose(td.mean.numpy(), np.asarray(jd.mean), rtol=1e-12)
    np.testing.assert_allclose(td.variance.numpy(), np.asarray(jd.variance), rtol=1e-12)
    np.testing.assert_allclose(td.log_prob(torch.from_numpy(value)).item(), float(jd.log_prob(jnp.asarray(value))),
                               rtol=1e-10)
    flat = value.reshape(-1) if interleaved else value.T.reshape(-1)
    np.testing.assert_allclose(td.loc.numpy(), mean.reshape(-1) if interleaved else mean.T.reshape(-1))
    np.testing.assert_allclose(td._task_to_flat(torch.from_numpy(value)).numpy(), flat)
    # independent tasks as a block-interleaved covariance
    mvns = [gt.distributions.MultivariateNormal(torch.from_numpy(mean[:, i]), torch.from_numpy(cov[:20, :20]))
            for i in range(2)]
    jmvns = [gp.distributions.MultivariateNormal(jnp.asarray(mean[:, i]), jnp.asarray(cov[:20, :20])) for i in range(2)]
    ti, ji = (gt.distributions.MultitaskMultivariateNormal.from_independent_mvns(mvns),
              gp.distributions.MultitaskMultivariateNormal.from_independent_mvns(jmvns))
    np.testing.assert_allclose(ti.log_prob(torch.from_numpy(value)).item(), float(ji.log_prob(jnp.asarray(value))),
                               rtol=1e-10)
    rep = gt.distributions.MultitaskMultivariateNormal.from_repeated_mvn(mvns[0], 3)
    assert rep.mean.shape == (20, 3) and torch.allclose(rep.variance[:, 2], mvns[0].variance)


@pytest.mark.parametrize("kind", ["matmul", "cat_rows", "cat_columns", "batch_repeat"])
def test_composition_operators_match_their_dense_matrices(kind):
    # the product, the row and column joins and the batch repeat of small dense operators:
    # product and diagonal against the formed matrix at 1e-12
    rng = np.random.default_rng(8)
    a, b = (torch.from_numpy(rng.normal(size=(6, 6))) for _ in range(2))
    A, B = gt.linop.DenseLinearOperator(a), gt.linop.DenseLinearOperator(b)
    op, dense = {
        "matmul": (gt.linop.MatmulLinearOperator(A, B), a @ b),
        "cat_rows": (gt.linop.CatLinearOperator([A, B], dim=-2), torch.cat([a, b], -2)),
        "cat_columns": (gt.linop.CatLinearOperator([A, B], dim=-1), torch.cat([a, b], -1)),
        "batch_repeat": (gt.linop.BatchRepeatLinearOperator(A, (3,)), a.expand(3, 6, 6)),
    }[kind]
    assert op.shape == tuple(dense.shape)
    v = torch.from_numpy(rng.normal(size=(dense.shape[-1], 2)))
    np.testing.assert_allclose(op.matmul(v).numpy(), (dense @ v).numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op.to_dense().numpy(), dense.numpy(), rtol=1e-12)
    if dense.shape[-1] == dense.shape[-2]:
        np.testing.assert_allclose(op._diagonal().numpy(), torch.diagonal(dense, dim1=-2, dim2=-1).numpy(), rtol=1e-12)


# -- exact multitask GPs ---------------------------------------------------------------------

def _multitask_task(n, t, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, n)
    f = np.stack([np.sin(6 * x), np.cos(5 * x), x**2 - 0.3][:t], -1)
    return x, f + 0.1 * rng.normal(size=(n, t))


def _kron_model(pkg, t, lcm=False):
    class MultitaskGP(pkg.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = pkg.means.MultitaskMean(pkg.means.ConstantMean(), num_tasks=t)
            if lcm:
                self.covar_module = pkg.kernels.LCMKernel([pkg.kernels.RBFKernel(), pkg.kernels.MaternKernel(nu=1.5)],
                                                          num_tasks=t, rank=1)
            else:
                self.covar_module = pkg.kernels.MultitaskKernel(pkg.kernels.RBFKernel(), num_tasks=t, rank=1)

        def forward(self, x):
            return pkg.distributions.MultitaskMultivariateNormal(self.mean_module(x), self.covar_module(x))

    return MultitaskGP


def _likelihood(pkg, t, rank, global_noise):
    return pkg.likelihoods.MultitaskGaussianLikelihood(num_tasks=t, rank=rank, has_global_noise=global_noise)


def _mbcg(mod, on):
    stack = contextlib.ExitStack()
    if on:
        for ctx in (mod.max_cholesky_size(0), mod.max_cg_iterations(500), mod.cg_tolerance(1e-10),
                    mod.eval_cg_tolerance(1e-10), mod.num_trace_samples(6), mod.max_lanczos_quadrature_iterations(30)):
            stack.enter_context(ctx)
    return stack


CASES = {
    "t2_rank0": (2, 0, True, False),
    "t2_rank1_no_global_noise": (2, 1, False, False),
    "t3_rank2": (3, 2, True, False),
    "t2_rank0_lcm": (2, 0, True, True),
}


@functools.lru_cache(maxsize=None)
def _jax_multitask(case, mbcg):
    """The JAX model's raw parameters (moved off their initial values), −MLL and its
    gradient, and the posterior mean and variance at 20 test points."""
    t, rank, global_noise, lcm = CASES[case]
    x, y = _multitask_task(N, t)
    jm = _kron_model(gp, t, lcm)(jnp.asarray(x), jnp.asarray(y), _likelihood(gp, t, rank, global_noise))
    rng = np.random.default_rng(3)
    params = {k: np.asarray(v) + 0.2 * rng.normal(size=np.shape(v)) for k, v in jm.trainable_params().items()}

    def loss(p, draws):
        _JAX_DRAWS["draws"] = draws
        m = jm.with_params(p)
        with _mbcg(gp.settings, mbcg):
            return -gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(jnp.asarray(x)), jnp.asarray(y),
                                                                         key=jax.random.PRNGKey(0))

    draws = {(N * t, 6): jnp.asarray(_draw((N * t, 6)))}
    value, grad = jax.jit(jax.value_and_grad(loss))(_jnp(params), draws)

    @jax.jit
    def posterior(p, xs):
        post = jm.with_params(p).eval()(xs)
        return post.mean, post.variance

    mean, var = posterior(_jnp(params), jnp.linspace(0.05, 0.95, 20))
    return params, float(value), {k: np.asarray(g) for k, g in grad.items()}, np.asarray(mean), np.asarray(var)


def _check_multitask(case, mbcg, rtol=RTOL):
    t, rank, global_noise, lcm = CASES[case]
    params, want, want_grad, want_mean, want_var = _jax_multitask(case, mbcg)
    x, y = _multitask_task(N, t)
    model = _kron_model(gt, t, lcm)(torch.from_numpy(x), torch.from_numpy(y), _likelihood(gt, t, rank, global_noise))
    model = gt.load_jax_params(model.double(), params)
    with _mbcg(gt.settings, mbcg):
        loss = -gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)(model(torch.from_numpy(x)),
                                                                             torch.from_numpy(y), base_samples=_draw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want, rtol=rtol)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grad[name], rtol=rtol,
                                   atol=rtol * np.abs(want_grad[name]).max(), err_msg=name)
    model.eval()
    with torch.no_grad():
        post = model(torch.linspace(0.05, 0.95, 20, dtype=torch.float64))
        assert isinstance(post, gt.distributions.MultitaskMultivariateNormal) and post.mean.shape == (20, t)
        np.testing.assert_allclose(post.mean.numpy(), want_mean, rtol=0, atol=rtol * np.abs(want_mean).max())
        np.testing.assert_allclose(post.variance.numpy(), want_var, rtol=0, atol=rtol * np.abs(want_var).max())


@pytest.mark.parametrize("case", ["t2_rank0", "t2_rank1_no_global_noise", "t3_rank2"])
def test_kronecker_multitask_gp_matches_jax_package(case):
    # n·t ≤ 192: the MLL and the predictions through one dense Cholesky factor in both
    # packages (the JAX model's raw parameters, moved off their initial values); 1e-9
    _check_multitask(case, mbcg=False)


def test_kronecker_multitask_mll_by_unpreconditioned_mbcg_matches_jax_package():
    # under max_cholesky_size(0): one CG loop over [y, 6 probes] of the sum
    # K_data ⊗ K_task + (I ⊗ D + σ²I), which has no preconditioner, at tolerance 1e-10 with
    # 30 Lanczos steps (the predictions solve by CG too).  1e-6 relative: each package stops
    # its CG at a relative residual below 1e-10, which pins a solve to cond(K̂)·1e-10 ≈ 6e-8
    # (cond ≈ 620 here), and round-off decides at which iteration each one stops
    _check_multitask("t3_rank2", mbcg=True, rtol=1e-6)


def test_lcm_multitask_gp_matches_jax_package():
    # LCMKernel([RBF, Matérn-3/2]) with 2 tasks: a sum of two Kronecker products; 1e-9
    _check_multitask("t2_rank0_lcm", mbcg=False)


def test_multitask_likelihood_forward_and_expected_log_prob_match_jax_package():
    params, *_ = _jax_multitask("t3_rank2", False)
    lik_params = {k[len("likelihood."):]: v for k, v in params.items() if k.startswith("likelihood.")}
    jl = _likelihood(gp, 3, 2, True).with_params(_jnp(lik_params))
    tl = gt.load_jax_params(_likelihood(gt, 3, 2, True).double(), lik_params)
    rng = np.random.default_rng(4)
    f, target = rng.normal(size=(10, 3)), rng.normal(size=(10, 3))
    a = rng.normal(size=(30, 30))
    dist = (gt.distributions.MultitaskMultivariateNormal(torch.from_numpy(f), torch.from_numpy(a @ a.T)),
            gp.distributions.MultitaskMultivariateNormal(jnp.asarray(f), jnp.asarray(a @ a.T)))
    with torch.no_grad():
        np.testing.assert_allclose(tl(torch.from_numpy(f)).stddev.numpy(), np.asarray(jl(jnp.asarray(f)).stddev),
                                   rtol=1e-12)
        np.testing.assert_allclose(tl.expected_log_prob(torch.from_numpy(target), dist[0]).numpy(),
                                   np.asarray(jl.expected_log_prob(jnp.asarray(target), dist[1])), rtol=1e-12)


# -- Hadamard multitask GP -------------------------------------------------------------------

def _hadamard_task(n):
    x_data = np.linspace(0, 1, n)
    x = np.stack([np.concatenate([np.zeros(n), np.ones(n)]), np.concatenate([x_data, x_data])], axis=-1)
    y = np.concatenate([np.sin(2 * np.pi * x_data), np.cos(2 * np.pi * x_data)])
    return x, y + 0.1 * np.random.default_rng(5).normal(size=2 * n)


def _hadamard_model(pkg):
    class HadamardGP(pkg.models.ExactGP):
        def __init__(self, x, y, likelihood):
            super().__init__(x, y, likelihood)
            self.mean_module = pkg.means.ConstantMean()
            self.data_kernel = pkg.kernels.RBFKernel(active_dims=(1,))
            self.task_kernel = pkg.kernels.IndexKernel(num_tasks=2, rank=1, active_dims=(0,))

        def forward(self, x):
            return pkg.distributions.MultivariateNormal(self.mean_module(x), self.data_kernel(x) * self.task_kernel(x))

    return HadamardGP


@functools.lru_cache(maxsize=None)
def _jax_hadamard():
    x, y = _hadamard_task(30)
    task_idx = jnp.asarray(x[:, 0].astype(np.int32))
    jm = _hadamard_model(gp)(jnp.asarray(x), jnp.asarray(y), gp.likelihoods.HadamardGaussianLikelihood(num_tasks=2))
    rng = np.random.default_rng(6)
    params = {k: np.asarray(v) + 0.2 * rng.normal(size=np.shape(v)) for k, v in jm.trainable_params().items()}

    def loss(p):
        m = jm.with_params(p)
        return -gp.mlls.ExactMarginalLogLikelihood(m.likelihood, m)(m(jnp.asarray(x)), jnp.asarray(y), task_idx)

    value, grad = jax.jit(jax.value_and_grad(loss))(_jnp(params))
    return params, float(value), {k: np.asarray(g) for k, g in grad.items()}


def test_hadamard_multitask_gp_matches_jax_package():
    # K_data ⊙ K_task, formed densely (an operator times an operator), plus each point's
    # task noise, at 2 × 30 points: the MLL and its gradient with the task indices passed to
    # the likelihood as the JAX package takes them (integers); 1e-9 relative
    params, want, want_grad = _jax_hadamard()
    x, y = _hadamard_task(30)
    model = _hadamard_model(gt)(torch.from_numpy(x), torch.from_numpy(y),
                                gt.likelihoods.HadamardGaussianLikelihood(num_tasks=2))
    model = gt.load_jax_params(model.double(), params)
    covar = model(torch.from_numpy(x)).lazy_covariance_matrix
    assert isinstance(covar, gt.linop.DenseLinearOperator)
    task_idx = torch.from_numpy(x[:, 0].astype(np.int64))
    loss = -gt.mlls.ExactMarginalLogLikelihood(model.likelihood, model)(model(torch.from_numpy(x)),
                                                                         torch.from_numpy(y), task_idx)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want, rtol=RTOL)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grad[name], rtol=RTOL, atol=RTOL * np.abs(want_grad[name]).max(),
                                   err_msg=name)
    # the JAX package's rule for other task indices: cast to integers, column 0 of 2-D ones
    prior = model(torch.from_numpy(x))
    np.testing.assert_array_equal(model.likelihood(prior, torch.from_numpy(x)).covariance_matrix.detach().numpy(),
                                  model.likelihood(prior, task_idx).covariance_matrix.detach().numpy())


def test_hadamard_prediction_with_a_task_feature_column_matches_the_dense_posterior():
    # the JAX package's Hadamard model cannot be served (its strategy passes the likelihood
    # no task indices); the port's strategy passes the training inputs, whose column 0 the
    # likelihood reads them from.  The posterior mean and variance at 10 points of each task
    # against the dense formulas μ* + K*x K̂⁻¹ (y − μ), K** − K*x K̂⁻¹ Kx*; 1e-6 relative
    # (the port's dense Cholesky factor adds a jitter of 1e-8 in float64, as the JAX
    # package's does, and the formulas none)
    params, *_ = _jax_hadamard()
    x, y = _hadamard_task(30)
    model = _hadamard_model(gt)(torch.from_numpy(x), torch.from_numpy(y),
                                gt.likelihoods.HadamardGaussianLikelihood(num_tasks=2))
    model = gt.load_jax_params(model.double(), params).eval()
    xs = torch.from_numpy(np.stack([np.repeat([0.0, 1.0], 10), np.tile(np.linspace(0.05, 0.95, 10), 2)], -1))
    with torch.no_grad():
        post = model(xs)
        full = torch.cat([torch.from_numpy(x), xs])
        K = (model.data_kernel(full) * model.task_kernel(full)).to_dense()
        noise = model.likelihood.task_noises[torch.from_numpy(x[:, 0]).long()]
        Khat = K[:60, :60] + torch.diag(noise)
        c = model.mean_module.constant
        mean = c + K[60:, :60] @ torch.linalg.solve(Khat, torch.from_numpy(y) - c)
        var = torch.diagonal(K[60:, 60:] - K[60:, :60] @ torch.linalg.solve(Khat, K[:60, 60:]))
        np.testing.assert_allclose(post.mean.numpy(), mean.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(post.variance.numpy(), var.numpy(), rtol=1e-6, atol=1e-6)
        noisy = model.likelihood(post, xs)
        np.testing.assert_allclose(noisy.variance.numpy(), (var + model.likelihood.task_noises[xs[:, 0].long()]).numpy(),
                                   rtol=1e-6)


# -- parameters ------------------------------------------------------------------------------

def test_load_jax_params_takes_list_and_batched_names():
    # the JAX package's trainable_params() names of LCM, multitask and batched models map
    # onto nn.ModuleList names and batched shapes unchanged
    jm = _kron_model(gp, 2, lcm=True)(jnp.zeros(5), jnp.zeros((5, 2)), _likelihood(gp, 2, 0, True))
    params = {k: np.asarray(v) for k, v in jm.trainable_params().items()}
    assert "covar_module.covar_module_list.0.task_covar_module.covar_factor" in params
    assert params["covar_module.covar_module_list.0.task_covar_module.covar_factor"].shape == (2, 1)
    assert "mean_module.base_means.1.raw_constant" in params and "likelihood.raw_task_noises" in params
    tm = gt.load_jax_params(_kron_model(gt, 2, lcm=True)(torch.zeros(5), torch.zeros(5, 2),
                                                         _likelihood(gt, 2, 0, True)).double(), params)
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[name])
    jl = gp.likelihoods.GaussianLikelihood(batch_shape=(2,))
    tl = gt.load_jax_params(gt.likelihoods.GaussianLikelihood(batch_shape=(2,)),
                            {"noise_covar.raw_noise": np.asarray(jl.trainable_params()["noise_covar.raw_noise"])})
    assert tl.noise_covar.raw_noise.shape == (2, 1)


def test_kronecker_added_diag_with_an_identity_factor_solves_in_closed_form():
    # I_n ⊗ Σ + σ²I, the multitask noise: the identity factor takes its trivial
    # eigendecomposition; solve and log-determinant against the dense matrix at 1e-12
    rng = np.random.default_rng(7)
    a = rng.normal(size=(3, 3))
    task = torch.from_numpy(a @ a.T + np.eye(3))
    kron = gt.linop.KroneckerProductLinearOperator(gt.linop.IdentityLinearOperator(4, torch.float64),
                                                   gt.linop.DenseLinearOperator(task))
    op = kron.add_diagonal(torch.tensor([0.3], dtype=torch.float64))
    assert isinstance(op, gt.linop.KroneckerProductAddedDiagLinearOperator)
    dense = np.kron(np.eye(4), task.numpy()) + 0.3 * np.eye(12)
    np.testing.assert_allclose(op.to_dense().numpy(), dense, rtol=1e-12)
    v = torch.from_numpy(rng.normal(size=(12, 2)))
    np.testing.assert_allclose(op.solve(v).numpy(), np.linalg.solve(dense, v.numpy()), rtol=1e-10)
    np.testing.assert_allclose(op.logdet().item(), np.linalg.slogdet(dense)[1], rtol=1e-12)


def test_fantasy_model_of_a_multitask_model_raises():
    x, y = _multitask_task(20, 2)
    model = _kron_model(gt, 2)(torch.from_numpy(x), torch.from_numpy(y), _likelihood(gt, 2, 0, True)).double().eval()
    # a multitask model's new targets join on the data axis (tests/test_torch_fantasy_batched.py
    # holds the values against the JAX package); targets of another number of tasks raise
    with pytest.raises(RuntimeError):
        model.get_fantasy_model(torch.zeros(2, dtype=torch.float64), torch.zeros(2, 3, dtype=torch.float64))
    fantasy = model.get_fantasy_model(torch.zeros(2, dtype=torch.float64), torch.zeros(2, 2, dtype=torch.float64))
    assert fantasy.train_targets.shape == (22, 2)
