"""The port's long tail of kernels, ``LessThan``, ``ZeroMean`` and ``ConstantKernel`` against the
JAX package, in float64 on the CPU.

* RQ, cosine, linear, polynomial, piecewise polynomial (q = 0-3), spectral mixture, spectral
  delta, constant, arc, cylindrical, Gibbs, Hamming IMQ, spherical linear and Gaussian
  symmetrised-KL kernels: the matrix of two inputs and of one (the symmetric call), the
  diagonal and, where the JAX kernel takes it, ``last_dim_is_batch``; a batch of two
  kernels for some;
* each kernel's product above ``max_eager_kernel_size``² (the lazy operator's blocks of rows,
  ``_matmul_chunked``, with blocks of 16 rows) against its dense matrix;
* ``SpectralMixtureKernel.initialize_from_data`` and ``initialize_from_data_empspect``, and
  ``SpectralDeltaKernel.initialize_from_data``: the same parameters from the same data;
* ``LessThan``: transform, inverse and ``intersect``; ``ZeroMean``; the helpers
  ``hamming_dist`` and ``project_onto_unit_sphere``.

The same numpy inputs and raw parameters (the JAX kernel's, moved off their initial values,
carried by ``load_jax_params``) go through both packages; the JAX side gets float64 distances
(its ``sq_dist`` forms the distance product in float32 even under x64).  Tolerance 1e-10
relative to the largest entry: both packages run the same float64 arithmetic in another
order.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpytorch_tpu as gp
import gpytorch_tpu_torch as gt
from gpytorch_tpu_torch.linop import lazy_kernel

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


def _moved(jk, seed=1):
    """The JAX kernel's raw parameters moved off their initial values, as numpy."""
    rng = np.random.default_rng(seed)
    return {k: np.asarray(v, dtype=np.float64) + 0.3 * rng.normal(size=np.shape(v))
            for k, v in jk.trainable_params().items()}


def _pair(make_jax, make_torch):
    jk = make_jax()
    params = _moved(jk)
    jk = jk.with_params({k: jnp.asarray(v) for k, v in params.items()})
    return jk, gt.load_jax_params(make_torch().double(), params)


def _dense(res):
    if hasattr(res, "to_dense"):
        res = res.to_dense()
    return res.detach().numpy() if torch.is_tensor(res) else np.asarray(res)


def _close(got, want, rtol=RTOL):
    got, want = _dense(got), _dense(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _kl_inputs(n, seed):
    # means and log-variances of diagonal Gaussians in D dimensions
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(size=(n, D)), 0.5 * rng.normal(size=(n, D))], -1)


def _one_hot(n, seed, length=5, vocab=4):
    rng = np.random.default_rng(seed)
    return np.eye(vocab)[rng.integers(vocab, size=(n, length))].reshape(n, length * vocab)


def _inputs(name, n, m):
    if name == "gaussian_kl":
        return _kl_inputs(n, 0), _kl_inputs(m, 1)
    if name == "hamming":
        return _one_hot(n, 0), _one_hot(m, 1)
    rng = np.random.default_rng(0)
    return rng.uniform(-1, 1, size=(n, D)), rng.uniform(-1, 1, size=(m, D))


def _both(cls, *args, **kwargs):
    """A kernel class of each package with the same arguments; kernels given as arguments
    are named by class name and built in each package."""
    def build(pkg, f64):
        built = [getattr(pkg.kernels, a[1])(**f64) if isinstance(a, tuple) else a for a in args]
        return getattr(pkg.kernels, cls)(*built, **kwargs, **f64)

    return lambda: build(gp, {"dtype": F64}), lambda: build(gt, {})


# (maker pair, takes last_dim_is_batch)
KERNELS = {
    "rq": (_both("RQKernel", ard_num_dims=D), True),
    "rq_batch2": (_both("RQKernel", batch_shape=(2,)), True),
    "cosine": (_both("CosineKernel"), True),
    "cosine_batch2": (_both("CosineKernel", batch_shape=(2,)), True),
    "linear": (_both("LinearKernel"), True),
    "polynomial3": (_both("PolynomialKernel", power=3), True),
    "polynomial2_batch2": (_both("PolynomialKernel", power=2, batch_shape=(2,)), True),
    **{f"piecewise_q{q}": (_both("PiecewisePolynomialKernel", q=q, ard_num_dims=D), True) for q in range(4)},
    "spectral_mixture": (_both("SpectralMixtureKernel", num_mixtures=3, ard_num_dims=D), True),
    "spectral_mixture_batch2": (_both("SpectralMixtureKernel", num_mixtures=2, ard_num_dims=D, batch_shape=(2,)), True),
    "spectral_delta": (_both("SpectralDeltaKernel", num_dims=D, num_deltas=8), True),
    "constant": (_both("ConstantKernel"), True),
    "constant_batch2": (_both("ConstantKernel", batch_shape=(2,)), True),
    "arc": (_both("ArcKernel", (None, "RBFKernel"), ard_num_dims=D), False),
    "cylindrical": (_both("CylindricalKernel", 3, (None, "RBFKernel")), False),
    "gibbs": (_both("GibbsKernel"), False),
    "hamming": (_both("HammingIMQKernel", vocab_size=4), False),
    "spherical_linear": (_both("SphericalLinearKernel"), False),
    "gaussian_kl": (_both("GaussianSymmetrizedKLKernel"), False),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_matches_jax_package(name):
    # the matrix of two inputs and of one, and the diagonal; 1e-10 relative to the largest entry
    makers, _ = KERNELS[name]
    jk, tk = _pair(*makers)
    x1, x2 = _inputs(name, 17, 11)
    j1, j2, t1, t2 = jnp.asarray(x1), jnp.asarray(x2), torch.from_numpy(x1), torch.from_numpy(x2)
    with torch.no_grad():
        _close(tk(t1, t2), jk(j1, j2))
        want_diag = jk(j1, j1, diag=True)
        _close(tk(t1, t1, diag=True), want_diag)
        # the symmetric matrix off its diagonal, and its diagonal against the diagonal call:
        # the JAX package's symmetric diagonal of a kernel of r = ‖x − x'‖ carries the square
        # root of its distance expansion's round-off (≈ 1e-8 where that is ≈ 1e-16), which
        # the port's zeroes, as the JAX package's ``dist`` does on identical inputs
        got, want = _dense(tk(t1)), _dense(jk(j1))
        off = ~np.eye(17, dtype=bool)
        np.testing.assert_allclose(got[..., off], want[..., off], rtol=RTOL, atol=RTOL * np.abs(want).max())
        _close(np.diagonal(got, axis1=-2, axis2=-1).copy(), want_diag)


# a batch of kernels whose hyperparameters do not broadcast against one matrix per input
# dimension: the JAX package raises (a TypeError or ValueError of broadcasting), and so does
# the port
_NO_BATCH_BY_DIM = ("polynomial2_batch2", "spectral_mixture_batch2", "constant_batch2")


@pytest.mark.parametrize("name", [k for k, (_, by_dim) in KERNELS.items() if by_dim])
def test_kernel_last_dim_is_batch_matches_jax_package(name):
    # one matrix per input dimension (…, d, n, m), and its diagonal; 1e-10
    makers, _ = KERNELS[name]
    jk, tk = _pair(*makers)
    x1, x2 = _inputs(name, 17, 11)
    j1, j2, t1, t2 = jnp.asarray(x1), jnp.asarray(x2), torch.from_numpy(x1), torch.from_numpy(x2)
    if name in _NO_BATCH_BY_DIM:
        with pytest.raises((TypeError, ValueError)):
            jk(j1, j2, last_dim_is_batch=True).to_dense()
        with pytest.raises(RuntimeError):
            tk(t1, t2, last_dim_is_batch=True).to_dense()
        return
    with torch.no_grad():
        got = tk(t1, t2, last_dim_is_batch=True)
        assert got.shape[-3:] == (D, 17, 11)
        _close(got, jk(j1, j2, last_dim_is_batch=True))
        _close(tk(t1, t1, diag=True, last_dim_is_batch=True), jk(j1, j1, diag=True, last_dim_is_batch=True))


@pytest.mark.parametrize("name", [k for k in KERNELS if not k.startswith(("linear", "spectral_delta"))])
def test_kernel_product_in_blocks_of_rows_matches_dense(monkeypatch, name):
    # above max_eager_kernel_size² the product streams by blocks of 16 rows of x1
    # (_matmul_chunked), and its gradient through them, against the dense matrix's; 1e-12.
    # On K(x1, x2) of distinct points: a block's distances centre on the block's mean, so a
    # distance near 0 takes other round-off there, which the square root of a kernel of
    # r = ‖x − x'‖ not smooth at 0 (piecewise polynomial, q = 0) would lift to ≈ 1e-8
    monkeypatch.setattr(lazy_kernel, "_CHUNK", 16)
    makers, _ = KERNELS[name]
    _, tk = _pair(*makers)
    x1, x2 = _inputs(name, 40, 30)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    v = torch.from_numpy(np.random.default_rng(3).normal(size=(30, 2)))
    op = tk(t1, t2)
    dense = op.to_dense()
    with gt.settings.max_eager_kernel_size(8):
        got = op.matmul(v)
    np.testing.assert_allclose(got.detach().numpy(), (dense @ v).detach().numpy(), rtol=1e-12, atol=1e-12)
    params = [p for p in tk.parameters()]
    if params:
        with gt.settings.max_eager_kernel_size(8):
            g_chunk = torch.autograd.grad(tk(t1, t2).matmul(v).square().sum(), params)
        g_dense = torch.autograd.grad((tk(t1, t2).to_dense() @ v).square().sum(), params)
        for a, b in zip(g_chunk, g_dense):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12 * b.abs().max().item())


def test_structured_kernels_return_their_roots():
    # the linear and spectral-delta kernels evaluate to a root of n × d (n × 2Q) on one
    # input and to a product of factors on two, at any size, as in the JAX package
    rng = np.random.default_rng(5)
    x1, x2 = torch.from_numpy(rng.normal(size=(9, D))), torch.from_numpy(rng.normal(size=(6, D)))
    for kernel, width in ((gt.kernels.LinearKernel().double(), D),
                          (gt.kernels.SpectralDeltaKernel(num_dims=D, num_deltas=5).double(), 10)):
        with torch.no_grad():
            sym, cross = kernel(x1).evaluate_kernel(), kernel(x1, x2).evaluate_kernel()
        assert isinstance(sym, gt.linop.RootLinearOperator) and sym.root.shape == (9, width)
        assert isinstance(cross, gt.linop.MatmulLinearOperator) and cross.shape == (9, 6)


def _sm_data(n=64):
    rng = np.random.default_rng(6)
    x = np.sort(rng.uniform(0, 10, size=(n, 2)), axis=0)
    y = np.sin(2 * np.pi * x[:, 0] / 3.0) + 0.3 * np.cos(x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y


@pytest.mark.parametrize("init", ["initialize_from_data", "initialize_from_data_empspect"])
def test_spectral_mixture_initialisers_match_jax_package(init):
    # the same numpy code and RandomState(0) in both: equal weights, means and scales (1e-12)
    x, y = _sm_data()
    jk = getattr(gp.kernels.SpectralMixtureKernel(num_mixtures=4, ard_num_dims=2, dtype=F64), init)(x, y)
    tk = gt.kernels.SpectralMixtureKernel(num_mixtures=4, ard_num_dims=2).double()
    assert getattr(tk, init)(torch.from_numpy(x), torch.from_numpy(y)) is tk
    for name in ("mixture_weights", "mixture_means", "mixture_scales"):
        np.testing.assert_allclose(getattr(tk, name).detach().numpy(), np.asarray(getattr(jk, name)), rtol=1e-12,
                                   err_msg=name)


def test_spectral_delta_initialiser_matches_jax_package():
    x, y = _sm_data()
    jk = gp.kernels.SpectralDeltaKernel(num_dims=2, num_deltas=6, dtype=F64).initialize_from_data(x, y)
    tk = gt.kernels.SpectralDeltaKernel(num_dims=2, num_deltas=6).double().initialize_from_data(x, y)
    np.testing.assert_allclose(tk.Z.detach().numpy(), np.asarray(jk.Z), rtol=1e-12)


def test_less_than_matches_jax_package():
    # transform and inverse (1e-12), the constraint's check, and intersect's bounds and type
    raw = np.linspace(-5.0, 5.0, 11)
    for upper in (0.0, 2.5):
        jc, tc = gp.constraints.LessThan(upper), gt.constraints.LessThan(upper)
        value = tc.transform(torch.from_numpy(raw))
        np.testing.assert_allclose(value.numpy(), np.asarray(jc.transform(jnp.asarray(raw))), rtol=1e-12)
        np.testing.assert_allclose(tc.inverse_transform(value).numpy(), raw, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(tc.inverse_transform(value).numpy(),
                                   np.asarray(jc.inverse_transform(jnp.asarray(value.numpy()))), rtol=1e-12)
        assert tc.check(value) and not tc.check(torch.tensor([upper + 1.0]))
    for other_j, other_t in ((gp.constraints.LessThan(1.0), gt.constraints.LessThan(1.0)),
                             (gp.constraints.Interval(-1.0, 3.0), gt.constraints.Interval(-1.0, 3.0)),
                             (gp.constraints.GreaterThan(0.5), gt.constraints.GreaterThan(0.5))):
        j, t = gp.constraints.LessThan(2.0).intersect(other_j), gt.constraints.LessThan(2.0).intersect(other_t)
        assert type(t).__name__ == type(j).__name__
        assert (t.lower_bound, t.upper_bound) == (j.lower_bound, j.upper_bound)
    with torch.no_grad():
        module = gt.kernels.RBFKernel(lengthscale_constraint=gt.constraints.LessThan(3.0)).double()
        module.lengthscale = 1.5
        np.testing.assert_allclose(module.lengthscale.item(), 1.5, rtol=1e-12)


@pytest.mark.parametrize("batch", [(), (2,)])
def test_zero_mean_matches_jax_package(batch):
    x = np.random.default_rng(7).normal(size=(5, D))
    want = np.asarray(gp.means.ZeroMean(batch_shape=batch)(jnp.asarray(x)))
    got = gt.means.ZeroMean(batch_shape=batch)(torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float64 and not got.any()
    assert gt.means.ZeroMean()(torch.from_numpy(x[:, 0])).shape == (5,)


def test_hamming_and_sphere_helpers_match_jax_package():
    a, b = _one_hot(6, 0).reshape(6, 5, 4), _one_hot(4, 1).reshape(4, 5, 4)
    np.testing.assert_allclose(gt.kernels.hamming_dist(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(gp.kernels.hamming_dist(jnp.asarray(a), jnp.asarray(b))), rtol=1e-12)
    x = np.random.default_rng(8).normal(size=(7, D))
    got = gt.kernels.project_onto_unit_sphere(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(gp.kernels.project_onto_unit_sphere(jnp.asarray(x))), rtol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-12)
