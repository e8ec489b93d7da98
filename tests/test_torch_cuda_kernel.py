"""The hand-written CUDA kernels (gpytorch_tpu_torch/csrc/kernel_matvec.cu, kernel_grad_x.cu,
kernel_bwd_fused.cu, kernel_periodic_matvec.cu and kernel_periodic_bwd_fused.cu) against
their plain PyTorch versions, on a GPU.  Every test here is
marked ``cuda`` and skips where there is no CUDA device: the kernels have no CPU mode.  This file imports neither JAX nor the JAX
package, so it also runs on a machine without them (from the repository root, where it finds
chip_smoke.py, whose sums of absolute terms scale the tolerances):

    python -m pytest tests/test_torch_cuda_kernel.py -m cuda -q --noconftest
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gpytorch_tpu_torch.ops import fused_kernels as fk
from gpytorch_tpu_torch.ops import periodic_kernels as ppk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(n, m, d, t, seed, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=device) for s in ((n, d), (m, d), (m, t)))


def _wide_data(n, m, d, t, seed, device):
    """As ``_data``, with the inputs scaled by 1/√d so that squared distances stay O(1) at
    any d (unscaled, K would underflow to 0 past a few dozen dims and check nothing)."""
    x1, x2, v = _data(n, m, d, t, seed, device)
    return x1 / d**0.5, x2 / d**0.5, v


# the wide-d tier (d > 64), ragged n ≠ m, t = 1, a column tile and a half, and two tiles
WIDE_CASES = [(300, 517, 65, 1), (517, 300, 100, 40), (129, 300, 200, 64)]

# strips, whose j range the wrappers split into slabs: serving's and acquisition's row
# counts against a ragged m that no slab length divides, at every tier of t
STRIP_N = (1, 100, 256, 2048)
STRIP_M = 20_011
STRIP_T = (1, 20, 33, 64, 100)
STRIP_CASES = [(n, STRIP_M, d, t) for n in STRIP_N for d in (3, 11, 100) for t in STRIP_T]
PERIODIC_STRIP_CASES = [(n, STRIP_M, d, t) for n in STRIP_N for d in (2, 100) for t in STRIP_T]


@pytest.mark.cuda
@pytest.mark.parametrize("ktype", fk.KERNEL_TYPES)
@pytest.mark.parametrize("n,m,d,t", [(1000, 1537, 3, 1), (1000, 1537, 11, 20), (129, 65, 3, 100), (1, 1, 1, 1),
                                     # the tiled tier of 16 columns, t ∈ (1, 16]
                                     (1000, 1537, 3, 16), (1000, 1537, 11, 5),
                                     # the tiled tiers of 20 and 32 columns, t ∈ (16, 20] and (20, 32]
                                     (1000, 1537, 3, 20), (1000, 1537, 3, 27),
                                     # the tensor-core tier, t ∈ (32, 64]
                                     (1000, 1537, 3, 33), (1000, 1537, 3, 64), (1000, 1537, 11, 33),
                                     (1000, 1537, 11, 64), *WIDE_CASES, *STRIP_CASES])
def test_cuda_kernel_matches_plain(cuda_device, ktype, n, m, d, t):
    x1, x2, v = (_wide_data if d > 64 else _data)(n, m, d, t, seed=ktype, device=cuda_device)
    before = fk.kernel_matvec_cuda.launches
    got = fk.fused_kernel_matvec(x1, x2, v, ktype)
    torch.cuda.synchronize()
    assert fk.kernel_matvec_cuda.launches == before + 1
    if (n, m, d, t) in STRIP_CASES:  # its grid is below the SM count: the j range is split
        assert fk.kernel_matvec_cuda.last_slabs > 1
    # the slabs' partials are folded without atomics: a second launch repeats the first
    assert torch.equal(got, fk.fused_kernel_matvec(x1, x2, v, ktype))
    want = fk._matvec_reference(x1.double(), x2.double(), v.double(), ktype)
    # float32 kernel against the float64 plain version, relative to K|v| (K ≥ 0): the sum
    # of absolute terms, which bounds the float32 summation error
    scale = fk._matvec_reference(x1.double(), x2.double(), v.double().abs(), ktype).abs().max()
    assert ((got.double() - want).abs().max() / scale).item() < 1e-5


def _one_slab_product(kernel, x1, x2, v, w=None):
    """The product by one direct launch of the kernel's C entry with one slab."""
    lib = fk.load_library()
    n, d = x1.shape
    m, t = v.shape
    out = torch.empty((n, t), dtype=torch.float32, device=x1.device)
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "rbf":
        rc = lib.gp_kernel_matvec_f32(x1.data_ptr(), x2.data_ptr(), v.data_ptr(), out.data_ptr(), n, m, d, t, fk.RBF,
                                      1, stream)
    else:
        rc = lib.gp_periodic_matvec_f32(x1.data_ptr(), x2.data_ptr(), w.data_ptr(), v.data_ptr(), out.data_ptr(), n, m,
                                        d, t, 1, stream)
    assert rc == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rbf", "periodic"])
@pytest.mark.parametrize("t", [1, 20, 64, 100])
def test_full_width_product_takes_one_slab(cuda_device, kernel, t):
    # a 100k-row product fills the card alone: the wrapper launches one slab, which sums as
    # the kernel did before the split (the same bits as one direct launch of one slab)
    n = 100_000
    if kernel == "rbf":
        x, _, v = _data(n, n, 3, t, seed=t, device=cuda_device)
        got, w = fk.kernel_matvec_cuda(x, x, v, fk.RBF), None
        assert fk.kernel_matvec_cuda.last_slabs == 1
    else:
        x, _, w, v = _periodic_data(n, n, 2, t, seed=t, device=cuda_device)
        got = ppk.periodic_matvec_cuda(x, x, w, v)
        assert ppk.periodic_matvec_cuda.last_slabs == 1
    assert torch.equal(got, _one_slab_product(kernel, x, x, v, w))


@pytest.mark.cuda
def test_cuda_wrapper_rejects_non_contiguous_and_mixed_devices(cuda_device):
    x1, x2, v = _data(64, 32, 3, 4, seed=0, device=cuda_device)
    with pytest.raises(ValueError):
        fk.kernel_matvec_cuda(x1, x2, v.t().contiguous().t(), fk.RBF)
    with pytest.raises(ValueError):
        fk.kernel_matvec_cuda(x1, x2, v.cpu(), fk.RBF)


@pytest.mark.cuda
@pytest.mark.parametrize("need_dv", [True, False])
@pytest.mark.parametrize("ktype", fk.KERNEL_TYPES)
@pytest.mark.parametrize("n,d,t", [(1537, 3, 64), (1537, 11, 20), (129, 3, 1), (1, 1, 1),
                                   (300, 65, 1), (517, 100, 40), (129, 200, 64),
                                   # the tensor-core tier, t ∈ (32, 64]: d = 3 and the
                                   # padded d ≤ 64, ragged against the block's rows
                                   (300, 3, 33), (517, 11, 64), (129, 64, 40)])
def test_cuda_backward_kernel_matches_plain(cuda_device, ktype, need_dv, n, d, t):
    # dv, where asked for, is one launch of the product kernel besides
    rng = np.random.default_rng(ktype)
    x, g, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=cuda_device) for s in ((n, d), (n, t), (n, t)))
    x = x / d**0.5 if d > 64 else x
    before = (fk.kernel_matvec_cuda.launches, fk.kernel_bwd_fused_cuda.launches)
    dv, dx, dos = fk.kernel_bwd_fused_cuda(x, g, v, ktype, need_dv=need_dv, need_dos=True)
    torch.cuda.synchronize()
    assert (fk.kernel_matvec_cuda.launches - before[0], fk.kernel_bwd_fused_cuda.launches - before[1]) == (int(need_dv), 1)
    # no atomics: a second launch repeats the first bit for bit
    _, dx2, dos2 = fk.kernel_bwd_fused_cuda(x, g, v, ktype, need_dv=False, need_dos=True)
    assert torch.equal(dx, dx2) and torch.equal(dos, dos2)
    x64, g64, v64 = x.double(), g.double(), v.double()
    want_dv, want_dx, want_dos = fk._bwd_fused_reference(x64, g64, v64, ktype, need_dv=need_dv, need_dos=True)
    bx, bdv, bdos = cs._bwd_abs_terms(x64, g64, v64, ktype)
    # float32 kernel against the float64 plain version, relative to the sums of absolute
    # terms, which bound the float32 summation error (dx of a single point is exactly 0)
    assert (dx.double() - want_dx).abs().max().item() <= 1e-5 * bx.max().item()
    assert abs(dos.double() - want_dos).item() <= 1e-5 * bdos.item()
    if 32 < t <= 64 and d <= 64:
        # the tensor-core tier forms dos in float64: only the per-row partials' and the
        # result's float32 roundings remain
        assert abs(dos.double() - want_dos).item() <= 2.0**-23 * abs(want_dos.item()) + 1e-8 * bdos.item()
    if need_dv:
        assert (dv.double() - want_dv).abs().max().item() <= 1e-5 * bdv.max().item()
    else:
        assert dv is None


@pytest.mark.cuda
@pytest.mark.parametrize("d,t", [pytest.param(3, 4, id="3"), pytest.param(100, 4, id="100"), pytest.param(3, 64, id="3-t64")])
def test_symmetric_gradient_runs_the_backward_kernel(cuda_device, d, t):
    # d = 100: a training gradient of a model with 100 inputs runs the wide-d tier; t = 64,
    # the training call's width, the tensor-core tier
    rng = np.random.default_rng(5)
    x, v, g = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=cuda_device) for s in ((300, d), (300, t), (300, t)))
    x = x / d**0.5 if d > 64 else x
    xs, os_ = x.clone().requires_grad_(True), torch.tensor(1.5, device=cuda_device, requires_grad=True)
    before = (fk.kernel_matvec_cuda.launches, fk.kernel_bwd_fused_cuda.launches)
    out = fk.fused_scaled_kernel_matvec(xs, xs, v, os_, fk.RBF, symmetric=True, grad_only=True)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert (fk.kernel_matvec_cuda.launches, fk.kernel_bwd_fused_cuda.launches) == (before[0], before[1] + 1)
    _, want_dx, want_dos = fk._bwd_fused_reference(x.double(), g.double(), v.double(), fk.RBF, need_dv=False, need_dos=True)
    torch.testing.assert_close(xs.grad.double(), 1.5 * want_dx, rtol=1e-4, atol=1e-4 * want_dx.abs().max().item())
    torch.testing.assert_close(os_.grad.double(), want_dos, rtol=1e-4, atol=0)


# grad_x's tensor-core tier (t ∈ (32, 128], d ≤ 64) at its edges and past them (t = 129, the
# FMA tier), d = 3 in registers and d = 11 padded, at ragged n ≪ m and n ≫ m and at a partial
# staged tile (m < 32) under one m-tile's rows (n < 16 rows of a warp)
GX_TC_CASES = [(n, m, d, t) for n, m in ((300, 1537), (1537, 300), (13, 19)) for d in (3, 11)
               for t in (33, 64, 100, 128, 129)]


def _grad_x_data(n, m, d, t, ktype, device):
    x1, x2, v = (_wide_data if d > 64 else _data)(n, m, d, t, seed=10 + ktype, device=device)
    g = torch.as_tensor(np.random.default_rng(ktype).normal(size=(n, t)), dtype=torch.float32, device=device)
    return x1, x2, g, v


def _check_grad_x(got, x1, x2, g, v, ktype):
    want = fk._grad_x_reference(x1.double(), x2.double(), g.double(), v.double(), ktype)
    assert torch.isfinite(got).all()
    if x1.shape[0] * x2.shape[0] <= 1537 * 300:
        # relative to the sum of absolute terms, which bounds the float32 summation error
        scale = cs._grad_x_abs_terms(x1.double(), x2.double(), g.double(), v.double(), ktype).max().item()
        assert (got.double() - want).abs().max().item() <= 1e-5 * scale
    else:
        assert (got.double() - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("ktype", fk.KERNEL_TYPES)
@pytest.mark.parametrize("n,m,d,t", [(300, 1537, 3, 1), (129, 65, 11, 20), (1, 1, 1, 1), (2048, 100_000, 3, 1),
                                     (2048, 100_000, 3, 100), (100_000, 2048, 3, 100), *GX_TC_CASES, *WIDE_CASES])
def test_cuda_grad_x_kernel_matches_plain(cuda_device, ktype, n, m, d, t):
    # ragged n ≪ m and n ≫ m, several column chunks, the tensor-core tier, the path's strip
    # (2,048 candidates against 100k training points, split into slabs of the j range) and
    # its training side, and the wide-d tier
    x1, x2, g, v = _grad_x_data(n, m, d, t, ktype, cuda_device)
    before = fk.kernel_grad_x_cuda.launches
    got = fk.kernel_grad_x_cuda(x1, x2, g, v, ktype)
    torch.cuda.synchronize()
    assert fk.kernel_grad_x_cuda.launches == before + 1
    _check_grad_x(got, x1, x2, g, v, ktype)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d,t", [(2048, 100_000, 3, 100), (2048, 100_000, 3, 1), (100_000, 2048, 3, 100),
                                     (1537, 300, 11, 64), (300, 1537, 3, 129)])
def test_cuda_grad_x_kernel_repeats_bit_for_bit(cuda_device, n, m, d, t):
    # every tier writes per-slab partials folded by torch.sum, with no atomics: a second
    # launch repeats the first
    x1, x2, g, v = _grad_x_data(n, m, d, t, fk.RBF, cuda_device)
    first = fk.kernel_grad_x_cuda(x1, x2, g, v, fk.RBF)
    if n < m:  # a strip: its j range is split
        assert fk.kernel_grad_x_cuda.last_slabs > 1
    assert torch.equal(first, fk.kernel_grad_x_cuda(x1, x2, g, v, fk.RBF))


@pytest.mark.cuda
@pytest.mark.parametrize("d,t", [(3, 1), (3, 100), (11, 64), (3, 129)])
def test_cuda_grad_x_coincident_points_matern05(cuda_device, d, t):
    # x1's rows are rows of x2: Matérn-½'s k′(0) = −0.5 / √1e-30 ≈ −5e14 meets a difference
    # of exactly 0, so each coincident pair adds 0 and the output stays finite and equal to
    # the plain version's
    x1, x2, g, v = _grad_x_data(300, 1537, d, t, fk.MATERN05, cuda_device)
    x2[100:400] = x1
    got = fk.kernel_grad_x_cuda(x1, x2, g, v, fk.MATERN05)
    torch.cuda.synchronize()
    _check_grad_x(got, x1, x2, g, v, fk.MATERN05)


@pytest.mark.cuda
@pytest.mark.parametrize("ktype", fk.KERNEL_TYPES)
def test_asymmetric_gradient_runs_the_grad_x_kernel(cuda_device, ktype):
    # the full asymmetric backward of the scaled product on the card (dx1 and dx2 by the
    # grad_x kernel, dv and dos by the K·V kernel) against the plain one in float64
    x1, x2, v = _data(300, 450, 3, 4, seed=20 + ktype, device=cuda_device)
    g = torch.as_tensor(np.random.default_rng(5).normal(size=(300, 4)), dtype=torch.float32, device=cuda_device)
    grads = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        a, b, w = (t.to(dev, dtype, copy=True).requires_grad_(True) for t in (x1, x2, v))
        o = torch.tensor(1.5, dtype=dtype, device=dev, requires_grad=True)
        before = (fk.kernel_matvec_cuda.launches, fk.kernel_grad_x_cuda.launches)
        (fk.fused_scaled_kernel_matvec(a, b, w, o, ktype) * g.to(dev, dtype)).sum().backward()
        launched = (fk.kernel_matvec_cuda.launches - before[0], fk.kernel_grad_x_cuda.launches - before[1])
        assert launched == ((3, 2) if dev == "cuda" else (0, 0))
        grads[dev] = [t.grad.double().cpu() for t in (a, b, w, o)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


# ---------------------------------------------------------------------------------------
# the periodic pair
# ---------------------------------------------------------------------------------------

def _periodic_data(n, m, d, t, seed, device):
    """x1p, x2p over many periods, w, v (float32)."""
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(-50.0, 300.0, size=(n, d)), rng.uniform(-50.0, 300.0, size=(m, d)),
              rng.uniform(0.5, 4.0, size=d), rng.normal(size=(m, t)))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrays)


# the periodic product's tensor-core tier, t ∈ (32, 64], over every register and staged tier
# of d, at ragged n and m (m < 32: one partial staged tile); (1000, 1537, 1, 64) is below
PERIODIC_TC_CASES = [(n, m, d, t) for n, m in ((1000, 1537), (77, 19)) for d in (1, 2, 3, 11, 64) for t in (33, 64)
                     if (n, m, d, t) != (1000, 1537, 1, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d,t", [(1000, 1537, 2, 1), (1000, 1537, 1, 64), (129, 65, 3, 100), (300, 200, 11, 20),
                                     (1, 1, 1, 1), *WIDE_CASES, *PERIODIC_TC_CASES,
                                     # t > 64: three 32-column tiles and a ragged one, summed per staged tile
                                     (1000, 1537, 2, 100), (77, 1537, 64, 100), *PERIODIC_STRIP_CASES])
def test_cuda_periodic_kernel_matches_plain(cuda_device, n, m, d, t):
    x1, x2, w, v = _periodic_data(n, m, d, t, seed=d + t, device=cuda_device)
    w = w / d if d > 11 else w  # keeps Σ_k w_k sin² O(1): K would underflow to 0 otherwise
    before = ppk.periodic_matvec_cuda.launches
    got = ppk.fused_periodic_matvec(x1, x2, w, v)
    torch.cuda.synchronize()
    assert ppk.periodic_matvec_cuda.launches == before + 1
    if (n, m, d, t) in PERIODIC_STRIP_CASES:  # its grid is below the SM count: the j range is split
        assert ppk.periodic_matvec_cuda.last_slabs > 1
    # the slabs' partials are folded without atomics: a second launch repeats the first
    assert torch.equal(got, ppk.fused_periodic_matvec(x1, x2, w, v))
    x1d, x2d, wd, vd = x1.double(), x2.double(), w.double(), v.double()
    want = ppk._periodic_matvec_reference(x1d, x2d, wd, vd)
    # relative to K|v| (K ≥ 0), the sum of absolute terms
    scale = ppk._periodic_matvec_reference(x1d, x2d, wd, vd.abs()).abs().max()
    assert ((got.double() - want).abs().max() / scale).item() < 1e-5


def _check_periodic_backward(got, x, w, g, v):
    """The kernel's (dv, dx, dw, dos) against the float64 plain version, relative to the
    sums of absolute terms (dx and dw of a single point are exactly 0); dv and dos only
    where the kernel returned them."""
    x64, w64, g64, v64 = x.double(), w.double(), g.double(), v.double()
    want = ppk._periodic_bwd_fused_reference(x64, w64, g64, v64, True, True)
    scales = cs._periodic_abs_terms(x64, x64, w64, v64, g64)
    assert got[1] is not None and got[2] is not None
    for a, b, scale, name in zip(got, want, scales, ("dv", "dx", "dw", "dos")):
        if a is not None:
            assert (a.double() - b).abs().max().item() <= 1e-5 * scale.max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("need_dv", [False, True])
@pytest.mark.parametrize("n,d,t", [(1537, 2, 64), (1537, 11, 20), (129, 3, 1), (300, 1, 33), (1, 1, 1), (517, 2, 100)])
def test_cuda_periodic_backward_kernel_matches_plain(cuda_device, n, d, t, need_dv):
    # with dos: the FMA tier at t = 1, 20 and 100, the tensor-core tier at 33 and 64; dv,
    # where asked for, is one launch of the product kernel besides
    x, _, w, g = _periodic_data(n, 1, d, t, seed=10 + d, device=cuda_device)
    g = g.new_tensor(np.random.default_rng(d).normal(size=(n, t)))
    v = g.new_tensor(np.random.default_rng(d + 1).normal(size=(n, t)))
    before = (ppk.periodic_matvec_cuda.launches, ppk.periodic_bwd_fused_cuda.launches)
    got = ppk.periodic_bwd_fused_cuda(x, w, g, v, need_dv, True)
    torch.cuda.synchronize()
    launched = (ppk.periodic_matvec_cuda.launches - before[0], ppk.periodic_bwd_fused_cuda.launches - before[1])
    assert launched == (int(need_dv), 1)
    assert (got[0] is not None) == need_dv and got[3] is not None
    _check_periodic_backward(got, x, w, g, v)


# the backward's tensor-core tier (t ∈ (32, 64], no dv): every register and staged tier of
# d, n ragged against the block's rows and the staged tile's, and a single point
PERIODIC_BWD_TC_CASES = [(n, d, t) for n in (1537, 77) for d in (1, 2, 3, 11, 64) for t in (33, 64)] + [(1, 2, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("need_dos", [True, False])
@pytest.mark.parametrize("n,d,t", PERIODIC_BWD_TC_CASES)
def test_cuda_periodic_backward_tc_tier_matches_plain(cuda_device, n, d, t, need_dos):
    x, _, w, _ = _periodic_data(n, 1, d, t, seed=20 + d + t, device=cuda_device)
    w = w / d if d > 11 else w  # keeps Σ_k w_k sin² O(1): K would underflow to 0 otherwise
    g, v = (torch.as_tensor(np.random.default_rng(n + i).normal(size=(n, t)), dtype=torch.float32, device=cuda_device)
            for i in range(2))
    before = (ppk.periodic_matvec_cuda.launches, ppk.periodic_bwd_fused_cuda.launches)
    got = ppk.periodic_bwd_fused_cuda(x, w, g, v, False, need_dos)
    torch.cuda.synchronize()
    assert (ppk.periodic_matvec_cuda.launches - before[0], ppk.periodic_bwd_fused_cuda.launches - before[1]) == (0, 1)
    assert got[0] is None and (got[3] is not None) == need_dos
    _check_periodic_backward(got, x, w, g, v)
    # no atomics: a second launch repeats the first bit for bit
    again = ppk.periodic_bwd_fused_cuda(x, w, g, v, False, need_dos)
    for a, b in zip(got[1:], again[1:]):
        assert a is None or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 64])
def test_symmetric_periodic_gradient_runs_the_backward_kernel(cuda_device, t):
    # the training call, σ² K v with v detached: one backward launch (the FMA tier at t = 1
    # and 4, the tensor-core tier at t = 64) and no product; with v's gradient asked for,
    # one product K·g besides
    x, _, w, v = _periodic_data(300, 300, 2, t, seed=7, device=cuda_device)
    g = torch.as_tensor(np.random.default_rng(8).normal(size=(300, t)), dtype=torch.float32, device=cuda_device)
    want_dv, want_dx, want_dw, want_dos = ppk._periodic_bwd_fused_reference(x.double(), w.double(), g.double(),
                                                                            v.double(), True, True)
    os_ = 1.3
    for need_v in (False, True):
        xs, ws = (a.clone().requires_grad_(True) for a in (x, w))
        vs = v.clone().requires_grad_(need_v)
        o = torch.tensor(os_, device=cuda_device, requires_grad=True)
        before = (ppk.periodic_matvec_cuda.launches, ppk.periodic_bwd_fused_cuda.launches)
        out = ppk.fused_scaled_periodic_matvec(xs, xs, ws, vs, o, symmetric=True, grad_only=True)
        (out * g).sum().backward()
        torch.cuda.synchronize()
        launched = (ppk.periodic_matvec_cuda.launches - before[0], ppk.periodic_bwd_fused_cuda.launches - before[1])
        assert launched == (int(need_v), 1)
        pairs = [(xs.grad, os_ * want_dx), (ws.grad, os_ * want_dw), (o.grad, want_dos)]
        pairs += [(vs.grad, os_ * want_dv)] if need_v else []
        for got, want in pairs:
            torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4 * want.abs().max().item())
