"""The port's periodic kernel products (gpytorch_tpu_torch/ops/periodic_kernels.py) against
the JAX package's: the plain product against its reference, the plain fused symmetric
backward against the Pallas kernel in interpret mode (float32: the Pallas kernel traces
only in float32) and in float64 against jax.grad of the dense loss and jax.vjp of the JAX
package's product, the general backward and the outputscale's gradient against the VJP of
the JAX package's custom-VJP product, and the autograd Function by gradcheck.

On the CPU everything takes the plain versions; the CUDA kernels themselves are checked
against them on a GPU by tests/test_torch_cuda_kernel.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import gpytorch_tpu as gp
from gpytorch_tpu.ops import pallas_kernels as pk
from gpytorch_tpu_torch.ops import periodic_kernels as ppk


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


def _inputs(seed, n, m, d, t, dtype=np.float64):
    """x1p, x2p spread over several periods (so that the fractional reduction is
    exercised), weights w and right-hand sides v, from numpy."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-4.0, 9.0, size=(n, d))
    x2 = rng.uniform(-4.0, 9.0, size=(m, d))
    w = rng.uniform(0.4, 2.5, size=d)
    v = rng.normal(size=(m, t))
    return tuple(a.astype(dtype) for a in (x1, x2, w, v))


def _t(*arrays, grad=False):
    return tuple(torch.from_numpy(a).requires_grad_(grad) for a in arrays)


@jax.jit
def _dense_grad(g, x, w, v):
    """jax.grad of Σ g ⊙ (K(x, x) v) over (x, w, v), K formed densely."""
    def loss(x_, w_, v_):
        diff = x_[:, None, :] - x_[None, :, :]
        K = jnp.exp(-2.0 * jnp.sum(w_ * jnp.sin(jnp.pi * diff) ** 2, axis=-1))
        return jnp.sum(g * (K @ v_))

    return jax.grad(loss, argnums=(0, 1, 2))(x, w, v)


@functools.partial(jax.jit, static_argnums=0)
def _jax_product_vjp(symmetric, g, x1, x2, w, v):
    """The JAX package's fused_periodic_matvec and its VJP (its reference branches on the
    CPU): symmetric, the cotangents of (x1, w, v), with x1 passed as both operands."""
    if symmetric:
        out, vjp = jax.vjp(lambda x, w_, v_: pk.fused_periodic_matvec(x, x, w_, v_), x1, w, v)
    else:
        out, vjp = jax.vjp(pk.fused_periodic_matvec, x1, x2, w, v)
    return out, vjp(g)


@functools.partial(jax.jit, static_argnums=0)
def _jax_scaled_product_vjp(symmetric, g, x1, x2, w, os_, v):
    """σ² K(x1, x2) v as the JAX package computes it, fused_periodic_matvec(x1, x2, w, σ² v),
    and its VJP: the cotangents of (x1, w, σ², v) if symmetric, else of (x1, x2, w, σ², v)."""
    if symmetric:
        out, vjp = jax.vjp(lambda x, w_, o, v_: pk.fused_periodic_matvec(x, x, w_, o * v_), x1, w, os_, v)
    else:
        out, vjp = jax.vjp(lambda a, b, w_, o, v_: pk.fused_periodic_matvec(a, b, w_, o * v_), x1, x2, w, os_, v)
    return out, vjp(g)


@pytest.mark.parametrize("t", [1, 5, 33])
@pytest.mark.parametrize("d", [1, 3])
def test_plain_product_matches_jax_reference(d, t):
    x1, x2, w, v = _inputs(10 + d + t, 57, 43, d, t)
    want = np.asarray(pk._periodic_matvec_reference(*(jnp.asarray(a) for a in (x1, x2, w, v))))
    got = ppk._periodic_matvec_reference(*_t(x1, x2, w, v), chunk=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("d", [3, 100])
def test_plain_product_matches_pallas_kernel_interpret(d, pallas_interpret_small_tiles):
    # float32, 40 × 70 over several periods; the weights divided by d so that Σ w sin² stays
    # O(1) at d = 100 (K would be all 0 otherwise); the tolerance of the backward's case
    x1, x2, w, v = _inputs(30 + d, 40, 70, d, 5, dtype=np.float32)
    w = w * np.float32(3.0 / d)
    want = pk._periodic_matvec_pallas(*(jnp.asarray(a) for a in (x1, x2, w, v)))
    got = ppk._periodic_matvec_reference(*_t(x1, x2, w, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4, atol=3e-4)


@jax.jit
def _pallas_product(x1, x2, w, v):
    return pk._periodic_matvec_pallas(x1, x2, w, v)


@pytest.mark.parametrize("t", [64, 100])
def test_plain_product_matches_pallas_kernel_interpret_at_path_arguments(t, pallas_interpret_small_tiles):
    # the path's shape of input: d = 2, a = x / period up to 355 (a daily period over a year
    # of readings), the weights of lengthscale 0.5, and the t of a training CG iteration and
    # of the LOVE root; 300 × 700 spans 3 row and 3 column tiles of the interpret run, both
    # ragged.  Float64 inputs, so that the Pallas kernel's own a − b is exact to 1e-13; its
    # product still accumulates in float32 (preferred_element_type), which sets the tolerance:
    # float32 rounding of each output against K|v|, the sum of its absolute terms
    rng = np.random.default_rng(70 + t)
    x1, x2 = (rng.uniform(0.0, 355.0, size=(r, 2)) for r in (300, 700))
    w = np.full(2, 4.0)
    v = rng.normal(size=(700, t))
    want = np.asarray(_pallas_product(*(jnp.asarray(a) for a in (x1, x2, w, v))))
    got = ppk._periodic_matvec_reference(*_t(x1, x2, w, v), chunk=128).numpy()
    scale = ppk._periodic_matvec_reference(*_t(x1, x2, w, np.abs(v))).numpy()
    assert np.abs(got - want).max() <= 1e-6 * scale.max()


@pytest.mark.parametrize("d", [1, 3])
def test_plain_fused_backward_matches_pallas_kernel_interpret(d, pallas_interpret_small_tiles):
    # float32 (the Pallas kernel's loop carries float32 sums, so it does not trace in
    # float64), 150 rows = 2 row tiles, one ragged; the tolerance of tests/test_pallas_interpret.py.
    # The twin's dw is the GG form, ½ of Σ K GG S², against the kernel's Σ K (g_i·v_j) S²
    rng = np.random.default_rng(20 + d)
    x = rng.normal(size=(150, d)).astype(np.float32)
    g, v = (rng.normal(size=(150, 4)).astype(np.float32) for _ in range(2))
    w = np.asarray([0.7, 1.3, 0.4][:d], dtype=np.float32)
    want = pk._periodic_bwd_fused_pallas(*(jnp.asarray(a) for a in (x, w, g, v)))
    got = ppk._periodic_bwd_fused_reference(*_t(x, w, g, v), need_dv=True, need_dos=True)
    for a, b, name in zip(got, want, ("dv", "dx", "dw")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4, atol=3e-4, err_msg=name)
    # without dv and dos: none returned, and the same dx and dw
    dv, dx, dw, dos = ppk._periodic_bwd_fused_reference(*_t(x, w, g, v), need_dv=False)
    assert dv is None and dos is None
    torch.testing.assert_close((dx, dw), got[1:3], rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [1, 37, 2048])
def test_plain_fused_backward_matches_dense_gradient(chunk):
    # float64, against jax.grad of Σ g ⊙ (K(x, x) v) over (x, w, v), with row blocks that
    # split the rows unevenly; dos against jax.vjp with respect to σ² of the JAX package's
    # fused_periodic_matvec(x, x, w, σ² v) at σ² = 1
    x, _, w, _ = _inputs(30, 70, 1, 2, 3)
    g, v = np.random.default_rng(31).normal(size=(2, 70, 3))
    want_dx, want_dw, want_dv = _dense_grad(jnp.asarray(g), jnp.asarray(x), jnp.asarray(w), jnp.asarray(v))
    want_dos = _jax_scaled_product_vjp(True, *(jnp.asarray(a) for a in (g, x, x, w, 1.0, v)))[1][2]
    dv, dx, dw, dos = ppk._periodic_bwd_fused_reference(*_t(x, w, g, v), need_dos=True, chunk=chunk)
    for got, want, name in ((dv, want_dv, "dv"), (dx, want_dx, "dx"), (dw, want_dw, "dw"), (dos, want_dos, "dos")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10 * np.abs(want).max(),
                                   err_msg=name)


def test_fused_backward_of_far_apart_points_matches_float64():
    # a ≈ 355 (a daily period over a year of readings): the float32 plain versions, which
    # reduce each point to its fraction, against float64, within float32 round-off
    rng = np.random.default_rng(32)
    x = (rng.uniform(0.0, 355.0, size=(200, 2))).astype(np.float32)
    g, v = (rng.normal(size=(200, 3)).astype(np.float32) for _ in range(2))
    w = np.asarray([4.0, 4.0], dtype=np.float32)
    got = ppk._periodic_bwd_fused_reference(*_t(x, w, g, v), need_dos=True)
    exact = ppk._periodic_bwd_fused_reference(*_t(*(a.astype(np.float64) for a in (x, w, g, v))), need_dos=True)
    for a, b, name in zip(got, exact, ("dv", "dx", "dw", "dos")):
        assert (a.double() - b).abs().max() <= 1e-5 * b.abs().max(), name
    out = ppk._periodic_matvec_reference(*_t(x, x, w, v))
    out64 = ppk._periodic_matvec_reference(*_t(*(a.astype(np.float64) for a in (x, x, w, v))))
    assert (out.double() - out64).abs().max() <= 1e-5 * out64.abs().max()


@pytest.mark.parametrize("symmetric", [False, True])
def test_product_gradients_match_jax_vjp(symmetric):
    # the Function against jax.vjp of the JAX package's fused_periodic_matvec (its
    # reference branches on the CPU); asymmetric: the general backward
    x1, x2, w, v = _inputs(40, 50, 35, 2, 3)
    g = np.random.default_rng(41).normal(size=(50, 3))
    if symmetric:
        v = np.random.default_rng(42).normal(size=(50, 3))
    out_j, want = _jax_product_vjp(symmetric, *(jnp.asarray(a) for a in (g, x1, x2, w, v)))
    a, w_t, v_t = _t(x1, w, v, grad=True)
    b = a if symmetric else torch.from_numpy(x2).requires_grad_(True)
    out = ppk.fused_periodic_matvec(a, b, w_t, v_t, symmetric=symmetric)
    out.backward(torch.from_numpy(g))
    got = (a.grad, w_t.grad, v_t.grad) if symmetric else (a.grad, b.grad, w_t.grad, v_t.grad)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-10, atol=1e-12)
    for gt_, wt in zip(got, want):
        np.testing.assert_allclose(gt_.numpy(), np.asarray(wt), rtol=1e-10, atol=1e-10 * np.abs(wt).max())


@pytest.mark.parametrize("symmetric", [False, True])
def test_scaled_product_gradients_match_jax_vjp(symmetric):
    # the scaled product σ² K v with σ² an operand, against jax.vjp of the JAX package's
    # fused_periodic_matvec(x1, x2, w, σ² v) (σ² folded into the right-hand side there):
    # the same function, its gradients (x, w, σ², v) reached another way
    x1, x2, w, v = _inputs(44, 50, 35, 2, 3)
    os_ = 1.7
    g = np.random.default_rng(45).normal(size=(50, 3))
    if symmetric:
        v = np.random.default_rng(46).normal(size=(50, 3))
    out_j, want = _jax_scaled_product_vjp(symmetric, *(jnp.asarray(a) for a in (g, x1, x2, w, os_, v)))
    a, w_t, v_t = _t(x1, w, v, grad=True)
    o = torch.tensor(os_, dtype=torch.float64, requires_grad=True)
    b = a if symmetric else torch.from_numpy(x2).requires_grad_(True)
    out = ppk.fused_scaled_periodic_matvec(a, b, w_t, v_t, o, symmetric=symmetric)
    out.backward(torch.from_numpy(g))
    got = (a.grad, w_t.grad, o.grad, v_t.grad) if symmetric else (a.grad, b.grad, w_t.grad, o.grad, v_t.grad)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-10, atol=1e-12)
    for gt_, wt in zip(got, want):
        np.testing.assert_allclose(gt_.numpy(), np.asarray(wt), rtol=1e-10, atol=1e-10 * np.abs(wt).max())


@pytest.mark.parametrize("need_v", [False, True])
def test_symmetric_scaled_backward_runs_one_fused_pass(need_v, monkeypatch):
    # the training call: one fused backward asked for dos and not for dv; dv, where v's
    # gradient is asked for, is one product K·g (the plain one here, on the CPU)
    calls = []
    for name in ("_periodic_product", "_periodic_bwd_fused", "_periodic_matvec_reference"):
        fn = getattr(ppk, name)
        monkeypatch.setattr(ppk, name, lambda *a, _fn=fn, _n=name: calls.append((_n, a[4:])) or _fn(*a))
    x, _, w, v = _t(*_inputs(47, 40, 40, 2, 4), grad=True)
    x.requires_grad_(True)
    v = v.detach().requires_grad_(need_v)
    o = torch.tensor(0.8, dtype=torch.float64, requires_grad=True)
    out = ppk.fused_scaled_periodic_matvec(x, x, w, v, o, symmetric=True, grad_only=True)
    assert torch.count_nonzero(out) == 0 and calls == []
    out.backward(torch.ones_like(out))
    want = [("_periodic_bwd_fused", (need_v, True))] + ([("_periodic_matvec_reference", (ppk._CHUNK,))] if need_v else [])
    assert calls == want
    assert (v.grad is not None) == need_v and o.grad is not None and w.grad is not None


@pytest.mark.parametrize("grad_only", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_gradcheck(symmetric, grad_only):
    # grad_only: the Function's value is zeros, so the checked function adds the plain
    # product of detached inputs (which share the inputs' storage and so see gradcheck's
    # perturbations): its value is the product, its analytic gradient the grad-only one
    x1, x2, w, v = _inputs(60, 12, 9, 2, 3)
    if symmetric:
        v = np.random.default_rng(61).normal(size=(12, 3))
    args = _t(x1, w, v, grad=True) if symmetric else _t(x1, x2, w, v, grad=True)

    def f(*a):
        x, y, w_, v_ = (a[0], a[0], a[1], a[2]) if symmetric else a
        out = ppk.fused_periodic_matvec(x, y, w_, v_, symmetric=symmetric, grad_only=grad_only)
        if grad_only:
            assert torch.count_nonzero(out) == 0
            out = out + ppk._periodic_matvec_reference(x.detach(), y.detach(), w_.detach(), v_.detach())
        return out

    assert torch.autograd.gradcheck(f, args)


@pytest.mark.parametrize("grad_only", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_gradcheck_scaled(symmetric, grad_only):
    # the scaled product's Function over (x, w, σ², v), as test_gradcheck does the unscaled
    x1, x2, w, v = _inputs(62, 12, 9, 2, 3)
    if symmetric:
        v = np.random.default_rng(63).normal(size=(12, 3))
    o = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    args = _t(x1, w, v, grad=True) + (o,) if symmetric else _t(x1, x2, w, v, grad=True) + (o,)

    def f(*a):
        x, y, w_, v_, o_ = (a[0], a[0], a[1], a[2], a[3]) if symmetric else a
        out = ppk.fused_scaled_periodic_matvec(x, y, w_, v_, o_, symmetric=symmetric, grad_only=grad_only)
        if grad_only:
            assert torch.count_nonzero(out) == 0
            out = out + o_.detach() * ppk._periodic_matvec_reference(x.detach(), y.detach(), w_.detach(), v_.detach())
        return out

    assert torch.autograd.gradcheck(f, args)


def test_symmetric_needs_one_tensor():
    x, _, w, v = _t(*_inputs(80, 6, 1, 2, 1))
    with pytest.raises(ValueError):
        ppk.fused_periodic_matvec(x, x.clone(), w, v, symmetric=True)


def _f32(*shapes):
    return tuple(torch.zeros(s, dtype=torch.float32) for s in shapes)


@pytest.mark.parametrize(
    "args,error",
    [
        (tuple(torch.zeros(s, dtype=torch.float64) for s in ((4, 2), (2,), (4, 3), (4, 3))), TypeError),  # dtype
        (_f32((4, 2), (2,), (4, 3), (4, 2)), ValueError),  # g and v differ
        (_f32((4, 2), (3,), (4, 3), (4, 3)), ValueError),  # one weight per dim
        (_f32((4, 2), (2,), (4, 3), (4, 3)), ValueError),  # a CPU tensor
    ],
)
def test_cuda_backward_wrapper_rejects_what_the_kernel_does_not_take(args, error):
    before = ppk.periodic_bwd_fused_cuda.launches
    with pytest.raises(error):
        ppk.periodic_bwd_fused_cuda(*args)
    assert ppk.periodic_bwd_fused_cuda.launches == before


def test_cuda_product_wrapper_rejects_cpu_tensors():
    before = ppk.periodic_matvec_cuda.launches
    with pytest.raises(ValueError):
        ppk.periodic_matvec_cuda(*_f32((4, 2), (5, 2), (2,), (5, 3)))
    assert ppk.periodic_matvec_cuda.launches == before


# chip_smoke.py's least time of the periodic product's tensor-core tier: the larger of the
# tensor cores' 3 × 2t operations a pair, the CUDA cores' 6d + 2 and the bytes
@pytest.mark.parametrize(
    "n,m,d,t,want_ms,term",
    [(100_000, 100_000, 2, 64, 7.758, "tensor"),  # the training CG shape: 7.758 ms, the tensor cores
     (100_000, 100_000, 2, 1, 2.090, "cuda"),  # t = 1: the CUDA cores' 14 operations a pair decide
     (2048, 100_000, 11, 33, 0.208, "cuda")],  # d = 11, t = 33: 68 CUDA-core operations against 198
)
def test_periodic_matvec_tc_bound(n, m, d, t, want_ms, term):
    ms, by = cs.periodic_matvec_tc_bound(n, m, d, t)
    assert by == "operations"
    assert ms == pytest.approx(want_ms, abs=5e-4)
    tensor_ms = 1e3 * 3 * 2 * t * n * m / cs.H100_TF32_FLOPS
    cuda_ms = 1e3 * (6 * d + 2) * n * m / cs.H100_FP32_FLOPS
    assert ms == pytest.approx(tensor_ms if term == "tensor" else cuda_ms, rel=1e-12)
    # the tensor-core term is matvec_tc_bound's at the same n, m, t (where it decides there)
    rbf_ms, rbf_by = cs.matvec_tc_bound(n, m, 1, t)
    if term == "tensor":
        assert (rbf_ms, rbf_by) == (pytest.approx(ms, rel=1e-12), "operations")


# chip_smoke.py's least times of the fused periodic backward: the tensor-core tier's (the
# score of depth 2t on the tensor cores against 15d + 4 CUDA-core operations a pair) and the
# FP32 cores' for the same work (dx, dw, dos)
@pytest.mark.parametrize(
    "n,d,t,want_tc,term,want_fp32",
    [(100_000, 2, 64, 15.515, "tensor", 43.284),  # the training call: the tensor cores decide
     (100_000, 11, 33, 25.224, "cuda", 44.925)],  # d = 11: 169 CUDA-core operations against 396
)
def test_periodic_bwd_bounds(n, d, t, want_tc, term, want_fp32):
    tc_ms, tc_by = cs.periodic_bwd_tc_bound(n, d, t)
    assert tc_by == "operations" and tc_ms == pytest.approx(want_tc, abs=5e-4)
    tensor_ms = 1e3 * 3 * 2 * (2 * t) * n * n / cs.H100_TF32_FLOPS
    cuda_ms = 1e3 * (15 * d + 4) * n * n / cs.H100_FP32_FLOPS
    assert tc_ms == pytest.approx(tensor_ms if term == "tensor" else cuda_ms, rel=1e-12)
    fp32_ms, fp32_by = cs.periodic_bwd_bound(n, d, t)
    assert fp32_by == "operations" and fp32_ms == pytest.approx(want_fp32, abs=5e-4)
