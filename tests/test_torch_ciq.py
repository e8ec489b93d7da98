"""The port's contour-integral quadrature (CIQ) and CIQ variational strategy against the JAX
package, in float64 on the CPU.

The same numpy inputs go through ``gpytorch_tpu.solvers.contour`` and the port's
``solvers/contour.py``: the elliptic quadrature nodes, the single-vector Lanczos that
estimates the spectrum, the multi-shift CG (also against direct solves), K^{-1/2}·b (also
against float64 ``eigh``), the quadrature-structured backward (against ``jax.grad`` of the
JAX ``_ciq_quad``) and a whitened CIQ-SVGP's ELBO and gradients at m = 96 inducing points
with K_ZZ lazy (``max_eager_kernel_size(64)``), so that the port's products go through the
fused product's plain version and its backward through the fused symmetric backward.  The
JAX side gets exact float64 distances (its ``sq_dist`` forms the distance product in
float32 even under x64) and is ``jax.jit``ted.

Tolerances are stated at each test: 1e-10 relative where both packages run the same
float64 arithmetic in another order and their multi-shift CG converges (``minres_tolerance``
1e-11).  Stopped early, at the default 1e-4, the two runs differ by more: once the Krylov
basis loses orthogonality, CG amplifies the libraries' different rounding (1e-8 relative
after 25 iterations on a 50 × 50 system of condition 40, from 1e-15 after 10).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt
from gpytorch_tpu.solvers import contour as jcontour
from gpytorch_tpu.solvers.lanczos import lanczos_tridiag as j_lanczos_tridiag
from gpytorch_tpu_torch.solvers import contour as tcontour

D, N, M, B = 3, 160, 96, 48
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


@pytest.fixture(autouse=True)
def jax_side(monkeypatch):
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)
    monkeypatch.setattr(sys.modules["gpytorch_tpu.kernels.kernel"], "_sq_dist_op", _exact_float64_sq_dist)


def _spd(n, seed, floor=0.05):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return A @ A.T / n + floor * np.eye(n)


def test_elliptic_nodes_match_jax():
    # shifts and weights of 15 nodes on three spectra, 1e-8 relative (the same float64 AGM and
    # Landen steps; the Landen recursion starts from sin(2³⁰·K'·u), whose huge argument
    # the two libraries reduce differently: 1.3e-9 on the widest spectrum)
    for lo, hi in ((1e-4, 50.0), (0.3, 2.0), (1e-7, 4e3)):
        js, jw = jax.jit(lambda a, b: jcontour._elliptic_nodes(a, b, 15))(jnp.asarray(lo), jnp.asarray(hi))
        ts, tw = tcontour._elliptic_nodes(torch.tensor(lo, dtype=torch.float64), torch.tensor(hi, dtype=torch.float64),
                                          15)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-8)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-8)


def test_lanczos_tridiag_and_spectrum_estimate_match_jax():
    # ten Lanczos steps from the ones vector: Q and T 1e-10, and the spectrum estimate
    K = _spd(40, 1)
    init = np.ones(40)
    jQ, jT = jax.jit(lambda k, v: j_lanczos_tridiag(lambda u: k @ u, v, 10))(jnp.asarray(K), jnp.asarray(init))
    tQ, tT = gt.solvers.lanczos_tridiag(lambda u: torch.from_numpy(K) @ u, torch.from_numpy(init), 10)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(tQ.numpy(), np.asarray(jQ), rtol=RTOL, atol=1e-12)
    j_est = jax.jit(lambda k: jcontour._estimate_spectrum(gp.linop.DenseLinearOperator(k)))(jnp.asarray(K))
    t_est = tcontour._estimate_spectrum(gt.linop.DenseLinearOperator(torch.from_numpy(K)))
    np.testing.assert_allclose([t.item() for t in t_est], [float(j) for j in j_est], rtol=RTOL)


def test_shifted_cg_against_direct_solves_and_jax():
    # four shifts, three columns, tolerance 1e-11: each shifted solution against
    # np.linalg.solve at 1e-8 relative, and the JAX package's at 1e-10 (the same iterations)
    K = _spd(60, 2)
    rhs = np.random.default_rng(3).normal(size=(60, 3))
    shifts = np.array([0.0, 1e-3, 0.1, 2.0])
    x, iters = tcontour.shifted_cg(lambda v: torch.from_numpy(K) @ v, torch.from_numpy(rhs), torch.from_numpy(shifts),
                                   200, 1e-11)
    for j, s in enumerate(shifts):
        direct = np.linalg.solve(K + s * np.eye(60), rhs)
        np.testing.assert_allclose(x[j].numpy(), direct, rtol=1e-8, atol=1e-8 * np.abs(direct).max())
    jx = jax.jit(lambda k, b, s: jcontour.shifted_cg(lambda v: k @ v, b, s, 200, 1e-11))(
        jnp.asarray(K), jnp.asarray(rhs), jnp.asarray(shifts))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=RTOL, atol=RTOL * np.abs(np.asarray(jx)).max())
    assert 0 < iters < 200


@pytest.mark.parametrize("case", ["defaults", "tight"])
def test_sqrt_inv_matmul_against_jax_and_eigh(case):
    # K^{-1/2} b: at the defaults (15 nodes, tolerance 1e-4, 100 iterations) against the JAX
    # package at 1e-6 relative (stopped early: 2e-7 read) and float64 eigh at 1e-4; with 30
    # nodes and tolerance 1e-11 against the JAX package at 1e-10 and eigh at 1e-9.
    # K^{1/2} b (inverse=False) likewise
    K = _spd(50, 4, floor=0.1)
    b = np.random.default_rng(5).normal(size=(50, 4))
    w, V = np.linalg.eigh(K)
    exact = {True: V @ np.diag(w ** -0.5) @ V.T @ b, False: V @ np.diag(w ** 0.5) @ V.T @ b}
    knobs = [] if case == "defaults" else [("num_contour_quadrature", 30), ("minres_tolerance", 1e-11),
                                           ("max_minres_iterations", 400)]

    def enter(pkg):
        import contextlib
        stack = contextlib.ExitStack()
        for name, value in knobs:
            stack.enter_context(getattr(pkg.settings, name)(value))
        return stack

    results = {}
    for inverse in (True, False):
        with enter(gp):
            jres = jax.jit(lambda k, r: jcontour.contour_integral_quad(gp.linop.DenseLinearOperator(k), r, inverse))(
                jnp.asarray(K), jnp.asarray(b))
        with enter(gt):
            top = gt.linop.DenseLinearOperator(torch.from_numpy(K))
            tres = top.sqrt_inv_matmul(torch.from_numpy(b)) if inverse else tcontour.contour_integral_quad(
                top, torch.from_numpy(b), inverse=False)
        scale = np.abs(exact[inverse]).max()
        results[inverse] = tres.numpy()
        rtol = 1e-6 if case == "defaults" else RTOL
        np.testing.assert_allclose(tres.numpy(), np.asarray(jres), rtol=rtol, atol=rtol * scale)
        limit = 1e-4 if case == "defaults" else 1e-9
        assert np.abs(tres.numpy() - exact[inverse]).max() / scale < limit
    # a vector right-hand side, and an lhs: bᵀ K^{-1/2} b
    with enter(gt):
        top = gt.linop.DenseLinearOperator(torch.from_numpy(K))
        vec = top.sqrt_inv_matmul(torch.from_numpy(b[:, 0]))
        lhs = top.sqrt_inv_matmul(torch.from_numpy(b), lhs=torch.from_numpy(b.T))
    assert vec.shape == (50,) and lhs.shape == (4, 4)
    assert np.abs(vec.numpy() - exact[True][:, 0]).max() / scale < limit
    np.testing.assert_allclose(lhs.numpy(), b.T @ results[True], rtol=1e-12, atol=1e-12 * np.abs(lhs.numpy()).max())


def test_ciq_backward_matches_jax_grad():
    # d/dK and d/db of Σ G ⊙ K^{-1/2} b through _ciq_quad's quadrature-structured backward
    # (a second multi-shift CG on the cotangent) against jax.grad of the JAX _ciq_quad,
    # 1e-10 relative, at the JAX package's nodes for this spectrum
    K = _spd(40, 6, floor=0.2)
    rng = np.random.default_rng(7)
    b, G = rng.normal(size=(40, 3)), rng.normal(size=(40, 3))
    js, jw = jcontour._elliptic_nodes(*jcontour._estimate_spectrum(gp.linop.DenseLinearOperator(jnp.asarray(K))), 15)

    def jax_obj(k, r):
        return jnp.sum(jnp.asarray(G) * jcontour._ciq_quad(gp.linop.DenseLinearOperator(k), r, (js, jw), 100))

    jgK, jgb = jax.jit(jax.grad(jax_obj, argnums=(0, 1)))(jnp.asarray(K), jnp.asarray(b))
    tK, tb = (torch.from_numpy(a).requires_grad_() for a in (K, b))
    op = gt.linop.DenseLinearOperator(tK)
    tensors, rebuild = op._flatten()
    out = tcontour._CIQQuad.apply(rebuild, tb, torch.tensor(np.asarray(js)), torch.tensor(np.asarray(jw)), 100,
                                  *tensors)
    (out * torch.from_numpy(G)).sum().backward()
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), rtol=RTOL, atol=RTOL * np.abs(np.asarray(jgb)).max())
    np.testing.assert_allclose(tK.grad.numpy(), np.asarray(jgK), rtol=RTOL, atol=RTOL * np.abs(np.asarray(jgK)).max())
    assert tcontour.last_iterations["backward"] > 0


def test_ciq_samples_are_the_operator_square_root():
    # under ciq_samples, zero_mean_mvn_samples is K^{1/2} ε by CIQ on the injected base
    # samples: against float64 eigh at 1e-9 with tight settings
    K = _spd(30, 8, floor=0.2)
    eps = np.random.default_rng(9).normal(size=(30, 5))
    w, V = np.linalg.eigh(K)
    with gt.settings.ciq_samples(True), gt.settings.num_contour_quadrature(30), gt.settings.minres_tolerance(1e-11), \
            gt.settings.max_minres_iterations(300):
        draws = gt.linop.DenseLinearOperator(torch.from_numpy(K)).zero_mean_mvn_samples(5, lambda shape: eps)
    assert draws.shape == (5, 30)
    exact = (V @ np.diag(w ** 0.5) @ V.T @ eps).T
    assert np.abs(draws.numpy() - exact).max() / np.abs(exact).max() < 1e-9


# -- the CIQ variational strategy ---------------------------------------------------------------

def _task(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * x[:, 2] + 0.1 * rng.normal(size=n)
    return x, y


def _params(Z, seed=3):
    rng = np.random.default_rng(seed)
    m = Z.shape[0]
    L = np.tril(0.1 * rng.normal(size=(m, m)), -1) + np.diag(rng.uniform(0.2, 0.6, size=m))
    name = "variational_strategy._variational_distribution."
    return {"covar_module.raw_outputscale": np.asarray(0.4),
            "covar_module.base_kernel.raw_lengthscale": rng.uniform(-2.2, -1.6, size=(1, D)),
            "mean_module.raw_constant": np.asarray(0.2),
            "variational_strategy.inducing_points": Z + 0.02 * rng.normal(size=Z.shape),
            name + "variational_mean": rng.normal(size=m), name + "chol_variational_covar": L}


JITTER = 1e-2  # K_ZZ + 1e-2·I: the multi-shift CG reaches its tolerance in both packages
LIK = {"noise_covar.raw_noise": np.asarray([-2.0])}


def _ciq_pair():
    x, y = _task()
    Z = x[np.random.default_rng(1).choice(N, M, replace=False)]
    params = _params(Z)

    class JaxSVGP(gp.models.ApproximateGP):
        def __init__(self):
            vd = gp.variational.CholeskyVariationalDistribution(M, dtype=F64)
            super().__init__(gp.variational.CiqVariationalStrategy(self, jnp.asarray(Z), vd, jitter_val=JITTER))
            self.mean_module = gp.means.ConstantMean(dtype=F64)
            self.covar_module = gp.kernels.ScaleKernel(gp.kernels.RBFKernel(ard_num_dims=D, dtype=F64), dtype=F64)

        def forward(self, xx):
            return gp.distributions.MultivariateNormal(self.mean_module(xx), self.covar_module(xx))

    class TorchSVGP(gt.models.ApproximateGP):
        def __init__(self):
            vd = gt.variational.CholeskyVariationalDistribution(M)
            super().__init__(gt.variational.CiqVariationalStrategy(self, torch.from_numpy(Z), vd, jitter_val=JITTER))
            self.mean_module = gt.means.ConstantMean()
            self.covar_module = gt.kernels.ScaleKernel(gt.kernels.RBFKernel(ard_num_dims=D))

        def forward(self, xx):
            return gt.distributions.MultivariateNormal(self.mean_module(xx), self.covar_module(xx))

    jm = JaxSVGP()
    jm(jnp.asarray(x[:4]))  # eager initialisation, then overwritten
    jm = jm.with_params({k: jnp.asarray(v) for k, v in params.items()})
    jl = gp.likelihoods.GaussianLikelihood(dtype=F64).with_params({k: jnp.asarray(v) for k, v in LIK.items()})
    tm, tl = TorchSVGP().double(), gt.likelihoods.GaussianLikelihood().double()
    gt.load_jax_params(tm, {**params, "variational_strategy.variational_params_initialized": 1})
    gt.load_jax_params(tl, LIK)
    return jm, jl, tm, tl, params, x[:B], y[:B]


def test_ciq_svgp_elbo_and_gradients_match_jax():
    # the ELBO of a minibatch of 48 at m = 96 (K_ZZ lazy above max_eager_kernel_size(64)) and
    # its gradient with respect to every parameter, against jax.value_and_grad, 1e-8
    # relative (the gradient's operator part through the fused backward's plain version);
    # the predictive mean and variance of the batch at 1e-10; the multi-shift CG converged
    # (tolerance 1e-11) in both packages, forward and backward
    jm, jl, tm, tl, params, xb, yb = _ciq_pair()

    def jax_elbo(p, xx, yy):
        m = jm.with_params(p)
        return gp.mlls.VariationalELBO(jl, m, num_data=N)(m(xx), yy)

    with gp.settings.max_eager_kernel_size(64), gp.settings.minres_tolerance(1e-11), \
            gp.settings.max_minres_iterations(400):
        jval, jgrad = jax.jit(jax.value_and_grad(jax_elbo))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(xb), jnp.asarray(yb))
        jout = jax.jit(lambda xx: (jm(xx).mean, jm(xx).variance))(jnp.asarray(xb))
    with gt.settings.max_eager_kernel_size(64), gt.settings.minres_tolerance(1e-11), \
            gt.settings.max_minres_iterations(400):
        out = tm(torch.from_numpy(xb))
        elbo = gt.mlls.VariationalELBO(tl, tm, num_data=N)(out, torch.from_numpy(yb))
    elbo.backward()  # outside the settings: the backward keeps the forward's tolerance
    assert 0 < tcontour.last_iterations["forward"] < 400 and 0 < tcontour.last_iterations["backward"] < 400
    np.testing.assert_allclose(elbo.item(), float(jval), rtol=RTOL)
    np.testing.assert_allclose(out.mean.detach().numpy(), np.asarray(jout[0]), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(out.variance.detach().numpy(), np.asarray(jout[1]), rtol=RTOL, atol=RTOL)
    own = dict(tm.named_parameters())
    for name, g in jgrad.items():
        g = np.asarray(g)
        np.testing.assert_allclose(own[name].grad.numpy(), g, rtol=1e-8, atol=1e-8 * max(np.abs(g).max(), 1e-30),
                                   err_msg=name)


def test_ciq_svgp_backward_is_one_fused_pass():
    # the ELBO's backward at m = 96 with K_ZZ lazy: the operator's cotangents come from one
    # symmetric fused backward over all 15 shifts' columns (t = 15 · 48) and no grad_x
    from gpytorch_tpu_torch.ops import fused_kernels as fk

    _, _, tm, tl, _, xb, yb = _ciq_pair()
    calls = {"bwd": [], "grad_x": 0}
    bwd, grad_x = fk._bwd_fused_reference, fk._grad_x_reference

    def counted_bwd(x, g, v, *args, **kwargs):
        calls["bwd"].append(tuple(v.shape))
        return bwd(x, g, v, *args, **kwargs)

    def counted_grad_x(*args, **kwargs):
        calls["grad_x"] += 1
        return grad_x(*args, **kwargs)

    fk._bwd_fused_reference, fk._grad_x_reference = counted_bwd, counted_grad_x
    try:
        with gt.settings.max_eager_kernel_size(64):
            (-gt.mlls.VariationalELBO(tl, tm, num_data=N)(tm(torch.from_numpy(xb)), torch.from_numpy(yb))).backward()
    finally:
        fk._bwd_fused_reference, fk._grad_x_reference = bwd, grad_x
    assert calls == {"bwd": [(M, 15 * B)], "grad_x": 0}


def test_ciq_elbo_constants_match_the_reference_script():
    # chip_smoke's CIQ_ELBO_JAX and OVC_PSEUDO_JAX are what tests/ciq_elbo_reference.py
    # prints (the JAX package, float64, exact distances), 1e-12 relative
    here = str(__import__("pathlib").Path(__file__).resolve().parent)
    sys.path[:0] = [here, str(__import__("pathlib").Path(here).parent)]
    import chip_smoke
    import ciq_elbo_reference

    np.testing.assert_allclose(ciq_elbo_reference.jax_ciq_elbo(), chip_smoke.CIQ_ELBO_JAX, rtol=1e-12)
    np.testing.assert_allclose(ciq_elbo_reference.jax_pseudo_points(), chip_smoke.OVC_PSEUDO_JAX, rtol=1e-12)
