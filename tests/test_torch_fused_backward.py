"""The port's kernel-product gradients (gpytorch_tpu_torch/ops/fused_kernels.py) against the
JAX package's: the fused symmetric backward against the Pallas kernel in interpret mode,
and the autograd Functions against jax.vjp of the JAX package's custom-VJP products on its
reference branch.

On the CPU the Functions take the plain versions; the CUDA backward kernel itself is
checked against the plain version on a GPU by tests/test_torch_cuda_kernel.py and
chip_smoke.py.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import gpytorch_tpu as gp
from gpytorch_tpu.ops import pallas_kernels as pk
from gpytorch_tpu_torch.ops import fused_kernels as fk

KERNEL_TYPES = [fk.RBF, fk.MATERN05, fk.MATERN15, fk.MATERN25]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def pallas_interpret_small_tiles(monkeypatch):
    # as tests/test_pallas_interpret.py: small tiles so ragged shapes span several tiles
    monkeypatch.setattr(pk, "_BN", 128)
    monkeypatch.setattr(pk, "_BM", 256)
    with gp.settings.pallas_interpret(True):
        yield


def _exact_float64_sq_dist(x1, x2, x1_eq_x2=False):
    # gpytorch_tpu's sq_dist forms its distance product in float32 even under x64; this is
    # the same expansion in float64, so that both packages see one kernel matrix
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


@pytest.fixture
def jax_float64_distances(monkeypatch):
    monkeypatch.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", _exact_float64_sq_dist)


def _arrays(seed, *shapes, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(dtype) for s in shapes)


def _t(*arrays, grad=False):
    return tuple(torch.from_numpy(a).requires_grad_(grad) for a in arrays)


# ---------------------------------------------------------------------------------------
# the fused symmetric backward: plain version against the Pallas kernel
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("need_dv", [True, False])
@pytest.mark.parametrize("ktype,d,t", [pytest.param(k, 3, 5, id=str(k)) for k in KERNEL_TYPES]
                         + [pytest.param(k, 100, 5, id=f"{k}-d100") for k in KERNEL_TYPES]
                         # t = 64: the training call's width (1 rhs + 63 probes), the CUDA
                         # kernel's tensor-core tier at d = 3 and its wide-d tier at d = 100
                         + [pytest.param(k, 3, 64, id=f"{k}-t64") for k in KERNEL_TYPES]
                         + [pytest.param(k, 100, 64, id=f"{k}-d100-t64") for k in KERNEL_TYPES])
def test_plain_fused_backward_matches_pallas_kernel_interpret(ktype, d, t, need_dv, pallas_interpret_small_tiles):
    # float32, ragged: 300 rows = 3 row tiles and 2 padded column tiles; the tolerances of
    # tests/test_pallas_interpret.py (3e-4) for dx and dv, and 2e-4 for dos.  d = 100 (the
    # Pallas kernel's quadratic-expansion path): 70 rows on the grid of eighths in [-1/4,
    # 1/4], where every squared distance of the expansion is exact in float32.  Off the grid
    # its diagonal keeps the expansion's round-off (~1e-7), which Matérn-½'s k(d2) = e^(−√d2)
    # turns into 3e-4 of K_ii, where the port's d2_ii is exactly 0
    if d == 3:
        x, g, v = _arrays(30 + ktype, (300, 3), (300, t), (300, t), dtype=np.float32)
    else:
        g, v = _arrays(30 + ktype, (70, t), (70, t), dtype=np.float32)
        x = (np.random.default_rng(40 + ktype).integers(-2, 3, size=(70, d)) / 8).astype(np.float32)
    want_dv, want_dx, want_dos = pk._bwd_fused_pallas(jnp.asarray(x), jnp.asarray(g), jnp.asarray(v), ktype,
                                                      need_dv=need_dv, need_dos=True)
    dv, dx, dos = fk._bwd_fused_reference(*_t(x, g, v), ktype, need_dv=need_dv, need_dos=True)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=3e-4, atol=3e-4, err_msg="dx")
    np.testing.assert_allclose(dos.item(), float(want_dos), rtol=2e-4, err_msg="dos")
    if need_dv:
        np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), rtol=3e-4, atol=3e-4, err_msg="dv")
    else:
        assert dv is None and want_dv is None


@pytest.mark.parametrize("chunk", [1, 77, 4096])
def test_plain_fused_backward_row_chunking(chunk):
    # against the dense float64 gradient of Σ g ⊙ (K(x, x) v): dx, dv and the outputscale
    # cotangent dos = Σ g ⊙ (K v)
    x, g, v = _arrays(5, (150, 3), (150, 4), (150, 4))
    xt, vt = _t(x, v, grad=True)
    K = torch.exp(-0.5 * ((xt[:, None, :] - xt[None, :, :]) ** 2).sum(-1))
    (torch.from_numpy(g) * (K @ vt)).sum().backward()
    dv, dx, dos = fk._bwd_fused_reference(*_t(x, g, v), fk.RBF, need_dv=True, need_dos=True, chunk=chunk)
    torch.testing.assert_close(dx, xt.grad, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(dv, vt.grad, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(dos, (torch.from_numpy(g) * (K.detach() @ torch.from_numpy(v))).sum(), rtol=1e-10, atol=0)


# ---------------------------------------------------------------------------------------
# the autograd Functions against jax.vjp on the JAX package's reference branch
# ---------------------------------------------------------------------------------------

def _jax_vjp(x1, x2, v, os_, ktype, g, symmetric):
    if symmetric:
        def f(x, v_, o):
            return pk.fused_scaled_kernel_matvec(x, x, v_, o, ktype)

        out, vjp = jax.vjp(f, jnp.asarray(x1), jnp.asarray(v), jnp.asarray(os_))
        dx, dv, dos = vjp(jnp.asarray(g))
        return out, (dx,), dv, dos
    out, vjp = jax.vjp(lambda a, b, v_, o: pk.fused_scaled_kernel_matvec(a, b, v_, o, ktype),
                       jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v), jnp.asarray(os_))
    dx1, dx2, dv, dos = vjp(jnp.asarray(g))
    return out, (dx1, dx2), dv, dos


# the JAX package's reference backward forms rowsum(W)·x − W·x without zeroing the exact
# diagonal, where Matérn-½'s k′(0) ~ 1/√eps; the port zeroes it (as the Pallas kernel
# does), so the symmetric case is held against the JAX package for the other three kernels
# and against the Pallas kernel for all four above
@pytest.mark.parametrize("ktype,symmetric", [(k, False) for k in KERNEL_TYPES] + [(k, True) for k in KERNEL_TYPES if k != fk.MATERN05])
def test_scaled_product_gradients_match_jax_vjp(ktype, symmetric, jax_float64_distances):
    x1, x2, v, g = _arrays(40 + ktype, (90, 3), (70, 3), (70, 4), (90, 4))
    if symmetric:
        x2, v = x1, _arrays(41, (90, 4))[0]
    os_ = np.array(1.7)
    out_j, dxs_j, dv_j, dos_j = _jax_vjp(x1, x2, v, os_, ktype, g, symmetric)

    a, v_t, o = _t(x1, v, os_, grad=True)
    b = a if symmetric else torch.from_numpy(x2).requires_grad_(True)
    out = fk.fused_scaled_kernel_matvec(a, b, v_t, o, ktype, symmetric=symmetric)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-10, atol=1e-12)
    dxs = (a.grad,) if symmetric else (a.grad, b.grad)
    for got, want in zip(dxs, dxs_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10 * np.abs(want).max())
    np.testing.assert_allclose(v_t.grad.numpy(), np.asarray(dv_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(o.grad.item(), float(dos_j), rtol=1e-10)


@pytest.mark.parametrize("symmetric", [False, True])
def test_unscaled_product_gradients_match_jax_vjp(symmetric, jax_float64_distances):
    x1, x2, v, g = _arrays(50, (80, 3), (60, 3), (60, 2), (80, 2))
    if symmetric:
        x2, v = x1, _arrays(51, (80, 2))[0]
        out_j, vjp = jax.vjp(lambda x, v_: pk.fused_kernel_matvec(x, x, v_, pk.MATERN25), jnp.asarray(x1), jnp.asarray(v))
    else:
        out_j, vjp = jax.vjp(lambda a, b, v_: pk.fused_kernel_matvec(a, b, v_, pk.MATERN25),
                             jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    a, v_t = _t(x1, v, grad=True)
    b = a if symmetric else torch.from_numpy(x2).requires_grad_(True)
    out = fk.fused_kernel_matvec(a, b, v_t, fk.MATERN25, symmetric=symmetric)
    out.backward(torch.from_numpy(g))
    got = (a.grad, v_t.grad) if symmetric else (a.grad, b.grad, v_t.grad)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-10, atol=1e-12)
    for gt_, w in zip(got, want):
        np.testing.assert_allclose(gt_.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10 * np.abs(w).max())


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("ktype", [fk.RBF, fk.MATERN25])
def test_gradcheck(ktype, symmetric):
    x1, x2, v = _arrays(60, (7, 2), (5, 2), (5, 3))
    if symmetric:
        x2, v = x1, _arrays(61, (7, 3))[0]
    a, v_t, o = _t(x1, v, np.array(0.8), grad=True)
    if symmetric:
        f = lambda x, v_, o_: fk.fused_scaled_kernel_matvec(x, x, v_, o_, ktype, symmetric=True)  # noqa: E731
        assert torch.autograd.gradcheck(f, (a, v_t, o))
    else:
        b = torch.from_numpy(x2).requires_grad_(True)
        f = lambda x, y, v_, o_: fk.fused_scaled_kernel_matvec(x, y, v_, o_, ktype)  # noqa: E731
        assert torch.autograd.gradcheck(f, (a, b, v_t, o))


@pytest.mark.parametrize("scaled", [False, True])
def test_grad_only_launches_no_forward_product(scaled, monkeypatch):
    # the value is zeros and no forward product runs; the gradient is the full one
    x, v, g = _arrays(70, (40, 3), (40, 3), (40, 3))
    calls = []
    product = fk._product
    monkeypatch.setattr(fk, "_product", lambda *args: calls.append(1) or product(*args))

    def run(grad_only):
        xt, vt, o = _t(x, v, np.array(1.3), grad=True)
        if scaled:
            out = fk.fused_scaled_kernel_matvec(xt, xt, vt, o, fk.RBF, symmetric=True, grad_only=grad_only)
        else:
            out = fk.fused_kernel_matvec(xt, xt, vt, fk.RBF, symmetric=True, grad_only=grad_only)
        (out * torch.from_numpy(g)).sum().backward()
        return out.detach(), xt.grad, vt.grad, o.grad

    out, *grads = run(grad_only=True)
    assert calls == [] and torch.count_nonzero(out) == 0
    _, *want = run(grad_only=False)
    assert calls == [1]
    for got, w in zip(grads, want):
        if w is not None:
            torch.testing.assert_close(got, w, rtol=0, atol=0)


def test_symmetric_needs_one_tensor():
    x, v = _t(*_arrays(80, (6, 2), (6, 1)))
    with pytest.raises(ValueError):
        fk.fused_kernel_matvec(x, x.clone(), v, fk.RBF, symmetric=True)


def _f32(*shapes):
    return tuple(torch.zeros(s, dtype=torch.float32) for s in shapes)


@pytest.mark.parametrize(
    "args,error",
    [
        (tuple(torch.zeros(s, dtype=torch.float64) for s in ((4, 3), (4, 2), (4, 2))), TypeError),  # dtype
        (_f32((4, 3), (4, 2), (4, 3)), ValueError),  # g and v differ
        (_f32((4, 3), (5, 2), (5, 2)), ValueError),  # rows of x and v differ
        (_f32((4, 3), (4, 2), (4, 2)), ValueError),  # a CPU tensor
    ],
)
def test_cuda_backward_wrapper_rejects_what_the_kernel_does_not_take(args, error):
    before = fk.kernel_bwd_fused_cuda.launches
    with pytest.raises(error):
        fk.kernel_bwd_fused_cuda(*args, fk.RBF, need_dv=False, need_dos=True)
    assert fk.kernel_bwd_fused_cuda.launches == before


# chip_smoke.py's least times of the fused backward: the tensor-core tier's for dx (the score
# of depth 2t on the tensor cores against 5d + 9 CUDA-core operations a pair), with dos in
# float64 besides (its score of depth t on the FP64 tensor cores, 3d + 4 float64 operations
# a pair), and the FP32 cores' for dx and dos
@pytest.mark.parametrize(
    "n,d,t,want_tc,term,want_fp32",
    [(100_000, 3, 64, 15.515, "tensor", 41.791),  # the training call: the tensor cores decide
     (100_000, 11, 33, 9.552, "cuda", 29.254)],  # d = 11: 64 CUDA-core operations against 396
)
def test_bwd_bounds(n, d, t, want_tc, term, want_fp32):
    tc_ms, tc_by = cs.bwd_tc_bound(n, d, t, dos=False)
    assert tc_by == "operations" and tc_ms == pytest.approx(want_tc, abs=5e-4)
    tensor_ms = 1e3 * 3 * 2 * (2 * t) * n * n / cs.H100_TF32_FLOPS
    cuda_ms = 1e3 * (5 * d + 9) * n * n / cs.H100_FP32_FLOPS
    assert tc_ms == pytest.approx(tensor_ms if term == "tensor" else cuda_ms, rel=1e-12)
    dos_ms, dos_by = cs.bwd_tc_bound(n, d, t)
    fp64_tensor_ms = 1e3 * 2 * t * n * n / cs.H100_FP64_TC_FLOPS
    fp64_ms = 1e3 * (3 * d + 4) * n * n / cs.H100_FP64_FLOPS
    assert dos_by == "operations" and dos_ms == pytest.approx(max(tensor_ms + fp64_tensor_ms, cuda_ms, fp64_ms),
                                                              rel=1e-12)
    fp32_ms, fp32_by = cs.bwd_bound(n, d, t)
    assert fp32_by == "operations" and fp32_ms == pytest.approx(want_fp32, abs=5e-4)


# … and with dv = K·g besides (the orthogonally decoupled KL's backward asks for it): 2t FLOP
# more a pair on the same k (the score's depth 3t on the tensor cores) and dv written once
@pytest.mark.parametrize("n,d,t", [(4096, 3, 1), (100_000, 3, 64)])
def test_bwd_bounds_with_dv(n, d, t):
    fp32_ms, fp32_by = cs.bwd_bound(n, d, t, dv=True)
    ops_ms = max(1e3 * (6 * t + 5 * d + 9) * n * n / cs.H100_FP32_FLOPS, cs.exp_floor_ms(n * n))
    assert fp32_by == "operations" and fp32_ms == pytest.approx(ops_ms, rel=1e-12)
    assert fp32_ms > cs.bwd_bound(n, d, t)[0]
    tc_ms, _ = cs.bwd_tc_bound(n, d, t, dv=True, dos=False)
    tensor_ms = 1e3 * 3 * 2 * (3 * t) * n * n / cs.H100_TF32_FLOPS
    assert tc_ms == pytest.approx(max(tensor_ms, 1e3 * (5 * d + 9) * n * n / cs.H100_FP32_FLOPS), rel=1e-12)
