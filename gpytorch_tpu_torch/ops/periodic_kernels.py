"""Streaming products with a periodic kernel matrix, and their gradients — the hot
operations of a periodic exact GP's serving and training.

    K_ij = exp(−2 Σ_k w_k sin²(π (a_ik − b_jk))),   a = x1 / period, b = x2 / period,
    w = 1 / lengthscale²

Counterpart of the periodic section of ``gpytorch_tpu/ops/pallas_kernels.py``.  What lives
here:

* the plain PyTorch versions, streamed in blocks of rows so that K is never held whole,
  even at N=100k: the product ``_periodic_matvec_reference``, the fused symmetric backward
  ``_periodic_bwd_fused_reference`` (the twins of the two CUDA kernels) and the general
  backward ``_periodic_backward_reference`` (plain on every device, as in the JAX package);
* the wrappers of the hand-written CUDA kernels ``csrc/kernel_periodic_matvec.cu`` and
  ``csrc/kernel_periodic_bwd_fused.cu`` (built with the package's other kernels, see
  ``ops/fused_kernels.py::build``);
* the differentiable products ``fused_periodic_matvec`` and, with the outputscale an
  operand of its own, ``fused_scaled_periodic_matvec`` (one ``torch.autograd.Function``).
  CPU tensors take the plain versions; CUDA tensors launch the CUDA kernels or raise —
  there is no fallback.

Every version reduces each point once to its fractional part f = a − round(a), which is
exact and changes neither sin² nor the backward's sin(2π ·): the difference of two large
arguments is never formed.  The product and the fused backward then take sin(π(a_i − a_j))
from per-point half-angle tables, s_i c_j − c_i s_j with s, c = sin, cos(πf), as the CUDA
kernels do; the general backward forms the differences f_i − f_j, as the JAX package does.
"""

from __future__ import annotations

import math

import torch

from .fused_kernels import _check_cuda_f32, _check_symmetric, _zeros_out, load_library, product_slabs

# rows per block of the plain streamed versions (the JAX package's general periodic
# backward chunks by 2048 rows: gpytorch_tpu/ops/pallas_kernels.py::_fpm_bwd)
_CHUNK = 2048

# the widest input of the fused symmetric backward (``periodic_common.cuh::kMaxDP``): the
# JAX package fuses it only for d ≤ 64 (gpytorch_tpu/ops/pallas_kernels.py::_fpm_bwd) and
# runs the plain general backward above, and so does ``_PeriodicMatvec.backward``
FUSED_BWD_MAX_D = 64


def _check_shapes(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor, v: torch.Tensor) -> None:
    if x1.ndim != 2 or x2.ndim != 2 or v.ndim != 2:
        raise ValueError(f"expected x1 (n, d), x2 (m, d), v (m, t); got {tuple(x1.shape)}, {tuple(x2.shape)}, {tuple(v.shape)}")
    if x1.shape[1] != x2.shape[1] or x2.shape[0] != v.shape[0]:
        raise ValueError(f"shape mismatch: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}, v {tuple(v.shape)}")
    if w.numel() != x1.shape[1]:
        raise ValueError(f"w must hold one weight per input dim ({x1.shape[1]}), got shape {tuple(w.shape)}")


def _fraction(xp: torch.Tensor) -> torch.Tensor:
    """f = a − round(a), in [−½, ½]: exact, and every periodic term has period 1 in a."""
    return xp - torch.round(xp)


def _half_angle(xp: torch.Tensor):
    """Per-point tables s = sin(πf), c = cos(πf) of the fractional parts."""
    a = math.pi * _fraction(xp)
    return torch.sin(a), torch.cos(a)


def _sin_diffs(si, ci, sj, cj):
    """S_k = sin(π(a_ik − a_jk)) up to sign, one (rows, m) matrix per input dim k; each
    product is rounded before the subtraction, so equal points give exactly 0."""
    return [si[:, k, None] * cj[None, :, k] - ci[:, k, None] * sj[None, :, k] for k in range(si.shape[1])]


def _kernel_block(S, wf) -> torch.Tensor:
    q = wf[0] * S[0] * S[0]
    for k in range(1, len(S)):
        q = q + wf[k] * S[k] * S[k]
    return torch.exp(-2.0 * q)


def _periodic_matvec_reference(x1p, x2p, w, v, chunk: int = _CHUNK) -> torch.Tensor:
    """Plain PyTorch K(x1p, x2p)·v, by blocks of ``chunk`` rows of x1p; each block holds
    a few (chunk, m) matrices."""
    _check_shapes(x1p, x2p, w, v)
    s1, c1 = _half_angle(x1p)
    s2, c2 = _half_angle(x2p)
    wf = w.reshape(-1)
    out = torch.empty((x1p.shape[0], v.shape[1]), dtype=torch.result_type(x1p, v), device=v.device)
    for i in range(0, x1p.shape[0], chunk):
        K = _kernel_block(_sin_diffs(s1[i : i + chunk], c1[i : i + chunk], s2, c2), wf)
        torch.matmul(K, v, out=out[i : i + chunk])
    return out


def _periodic_bwd_fused_reference(xp, w, g, v, need_dv: bool = True, need_dos: bool = False, chunk: int = _CHUNK):
    """Plain version of the fused symmetric backward (the CUDA kernel's twin): for
    out = K(xp, xp) v and the cotangent g, (dv, dx, dw, dos) with the score
    GG_ij = g_i·v_j + v_i·g_j = [g_i | v_i]·[v_j | g_j],
    dv = K g, dx_ik = −4π w_k Σ_j K_ij GG_ij S_ijk C_ijk, dw_k = −Σ_ij K_ij GG_ij S_ijk² and
    dos = ½ Σ_ij K_ij GG_ij, where S and C are sin and cos of π(a_ik − a_jk)
    (2 S C = sin 2π(a_ik − a_jk)).  The function of
    ``gpytorch_tpu/ops/pallas_kernels.py::_periodic_bwd_fused_pallas``, whose dw is
    −2 Σ_ij K_ij (g_i·v_j) S_ijk²: K and S² are symmetric in (i, j), so that sum is half of
    Σ_ij K_ij GG_ij S_ijk², and dos = Σ_ij K_ij (g_i·v_j) half of Σ_ij K_ij GG_ij; every
    output is a sum of one score a pair.  dv and dos are ``None`` unless asked for; dv is
    the plain product K·g, as the CUDA wrapper's is the product kernel's.  Streamed by
    blocks of rows."""
    _check_shapes(xp, xp, w, v)
    if g.shape != v.shape:
        raise ValueError(f"g {tuple(g.shape)} and v {tuple(v.shape)} differ")
    s, c = _half_angle(xp)
    wf = w.reshape(-1)
    n, d = xp.shape
    vg = torch.cat((v, g), -1)
    dv = _periodic_matvec_reference(xp, xp, w, g, chunk) if need_dv else None
    dx = torch.empty_like(xp)
    dw = torch.zeros(d, dtype=xp.dtype, device=xp.device)
    dos = torch.zeros((), dtype=v.dtype, device=v.device)
    for i in range(0, n, chunk):
        sb, cb = s[i : i + chunk], c[i : i + chunk]
        S = _sin_diffs(sb, cb, s, c)
        K = _kernel_block(S, wf)
        KG = K * (torch.cat((g[i : i + chunk], v[i : i + chunk]), -1) @ vg.mT)
        if need_dos:
            dos += KG.sum()
        for k in range(d):
            C = cb[:, k, None] * c[None, :, k] + sb[:, k, None] * s[None, :, k]
            dx[i : i + chunk, k] = (-4.0 * math.pi) * wf[k] * (KG * S[k] * C).sum(-1)
            dw[k] -= (KG * S[k] * S[k]).sum()
    return dv, dx, dw, (0.5 * dos if need_dos else None)


def _periodic_backward_reference(x1p, x2p, w, g, v, need_dv: bool = True, chunk: int = _CHUNK):
    """Plain general backward of Σ g ⊙ (K(x1p, x2p) v): (dv, dx1, dx2, dw), by blocks of
    rows of x1p — the non-fused branch of ``gpytorch_tpu/ops/pallas_kernels.py::_fpm_bwd``,
    which the JAX package also computes without a kernel.  With G = K ⊙ (g vᵀ) and
    Δ = f1_i − f2_j: dx1 = −2π w Σ_j G sin(2πΔ), dx2 = 2π w Σ_i G sin(2πΔ),
    dw = −2 Σ G sin²(πΔ); dv = Kᵀ g (the product, a kernel launch on the card) where asked
    for, ``None`` otherwise."""
    _check_shapes(x1p, x2p, w, v)
    wf = w.reshape(-1)
    dv = _periodic_product(x2p, x1p, w, g) if need_dv else None
    f1, f2 = _fraction(x1p), _fraction(x2p)
    dx1 = torch.empty_like(x1p)
    dx2 = torch.zeros_like(x2p)
    dw = torch.zeros_like(wf)
    for i in range(0, x1p.shape[0], chunk):
        diff = f1[i : i + chunk, None, :] - f2[None, :, :]  # (c, m, d)
        sin_pi = torch.sin(math.pi * diff)
        K = torch.exp(-2.0 * (wf * sin_pi * sin_pi).sum(-1))
        G = K * (g[i : i + chunk] @ v.mT)
        trig = torch.sin(2.0 * math.pi * diff)
        dx1[i : i + chunk] = -2.0 * math.pi * wf * torch.einsum("cm,cmd->cd", G, trig)
        dx2 += 2.0 * math.pi * wf * torch.einsum("cm,cmd->md", G, trig)
        dw += -2.0 * torch.einsum("cm,cmd->d", G, sin_pi * sin_pi)
    return dv, dx1, dx2, dw


# ----------------------------------------------------------------------------------------
# the CUDA kernels (built and loaded by ops/fused_kernels.py)
# ----------------------------------------------------------------------------------------

class PeriodicMatvecCUDA:
    """Wrapper of the periodic K·V kernel: checks its inputs, chooses the slab split
    (``fused_kernels.product_slabs``), allocates the output (the per-slab partials where
    there is more than one slab, folded with ``torch.sum``), launches on the current
    stream, counts its launches in ``launches`` and keeps the last launch's slab count in
    ``last_slabs``."""

    def __init__(self):
        self.launches = 0
        self.last_slabs = 0

    def __call__(self, x1p: torch.Tensor, x2p: torch.Tensor, w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        _check_shapes(x1p, x2p, w, v)
        _check_cuda_f32(x1p=x1p, x2p=x2p, w=w, v=v)
        n, d = x1p.shape
        m, t = v.shape
        if n == 0 or t == 0:
            return torch.empty((n, t), dtype=torch.float32, device=x1p.device)
        slabs = product_slabs("gp_periodic_matvec_plan", x1p.device, m, n, d, t)
        out = torch.empty((slabs, n, t), dtype=torch.float32, device=x1p.device)
        lib = load_library()
        with torch.cuda.device(x1p.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gp_periodic_matvec_f32(
                x1p.data_ptr(), x2p.data_ptr(), w.data_ptr(), v.data_ptr(), out.data_ptr(), n, m, d, t, slabs, stream
            )
        if rc != 0:
            raise RuntimeError(f"periodic_matvec launch failed: CUDA error {rc}")
        self.launches += 1
        self.last_slabs = slabs
        return out[0] if slabs == 1 else out.sum(0)


periodic_matvec_cuda = PeriodicMatvecCUDA()


class PeriodicBwdFusedCUDA:
    """Wrapper of the fused symmetric periodic backward kernel: returns (dv, dx, dw, dos)
    as ``_periodic_bwd_fused_reference`` does.  Allocates the per-chunk raw per-row dx, dw
    and dos partials (as many chunks as the library says), launches on the current
    stream, folds the partials with ``torch.sum``, applies the constant factors and counts
    its launches in ``launches``.  The kernel forms no dv: where it is asked for, dv = K·g
    is one launch of the product kernel (counted by ``periodic_matvec_cuda``)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, xp: torch.Tensor, w: torch.Tensor, g: torch.Tensor, v: torch.Tensor, need_dv: bool = True,
                 need_dos: bool = False):
        _check_shapes(xp, xp, w, v)
        if g.shape != v.shape:
            raise ValueError(f"g {tuple(g.shape)} and v {tuple(v.shape)} differ")
        _check_cuda_f32(xp=xp, w=w, g=g, v=v)
        n, d = xp.shape
        t = v.shape[1]
        if d > FUSED_BWD_MAX_D:
            raise ValueError(f"the fused backward kernel takes at most {FUSED_BWD_MAX_D} input dims, got {d}")
        dev = xp.device
        if n == 0 or t == 0:
            dos = torch.zeros((), dtype=torch.float32, device=dev) if need_dos else None
            return (torch.zeros_like(v) if need_dv else None), torch.zeros_like(xp), torch.zeros_like(w.reshape(-1)), dos
        lib = load_library()
        chunks = lib.gp_periodic_bwd_fused_chunks(t)
        dx_part = torch.empty((chunks, n, d), dtype=torch.float32, device=dev)
        dw_part = torch.empty((chunks, n, d), dtype=torch.float32, device=dev)
        dos_part = torch.empty((chunks, n), dtype=torch.float32, device=dev) if need_dos else None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gp_periodic_bwd_fused_f32(
                xp.data_ptr(), w.data_ptr(), g.data_ptr(), v.data_ptr(), dx_part.data_ptr(), dw_part.data_ptr(),
                dos_part.data_ptr() if need_dos else None, n, d, t, int(need_dos), stream,
            )
        if rc != 0:
            raise RuntimeError(f"periodic_bwd_fused launch failed: CUDA error {rc}")
        self.launches += 1
        dv = periodic_matvec_cuda(xp, xp, w, g) if need_dv else None
        wf = w.reshape(-1)
        dx = (-4.0 * math.pi) * wf * (dx_part[0] if chunks == 1 else dx_part.sum(0))
        dw = -dw_part.sum((0, 1))
        return dv, dx, dw, (0.5 * dos_part.sum() if need_dos else None)


periodic_bwd_fused_cuda = PeriodicBwdFusedCUDA()


# ----------------------------------------------------------------------------------------
# dispatch and the differentiable products
# ----------------------------------------------------------------------------------------

def _periodic_product(x1p, x2p, w, v) -> torch.Tensor:
    if x1p.is_cuda:
        return periodic_matvec_cuda(x1p, x2p, w, v)
    if x1p.device.type != "cpu":
        raise ValueError(f"unsupported device {x1p.device}")
    return _periodic_matvec_reference(x1p, x2p, w, v)


def _periodic_bwd_fused(xp, w, g, v, need_dv, need_dos):
    if xp.is_cuda:
        return periodic_bwd_fused_cuda(xp, w, g, v, need_dv, need_dos)
    if xp.device.type != "cpu":
        raise ValueError(f"unsupported device {xp.device}")
    return _periodic_bwd_fused_reference(xp, w, g, v, need_dv, need_dos)


class _PeriodicMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1p, x2p, w, v, outputscale, symmetric, grad_only):
        ctx.save_for_backward(x1p, x2p, w, v, outputscale)
        ctx.symmetric = symmetric
        if grad_only:
            return _zeros_out(x1p, v)
        return _periodic_product(x1p, x2p, w, v if outputscale is None else (outputscale * v).contiguous())

    @staticmethod
    def backward(ctx, g):
        x1p, x2p, w, v, os_ = ctx.saved_tensors
        need_dv, need_dos = ctx.needs_input_grad[3:5]
        g = g.contiguous()
        if ctx.symmetric and x1p.shape[-1] <= FUSED_BWD_MAX_D:
            # one fused pass gives dx (the whole cotangent of the one input tensor), dw and
            # dos; dv = K g, which training never asks for, is one product besides
            dv, dx1, dw, dos = _periodic_bwd_fused(x1p, w, g, v, need_dv, need_dos)
            dx2 = None
        else:
            dv, dx1, dx2, dw = _periodic_backward_reference(x1p, x2p, w, g, v, need_dv=need_dv)
            dos = (g * _periodic_product(x1p, x2p, w, v)).sum() if need_dos else None
        if os_ is not None:
            dx1, dx2, dw, dv = (None if t is None else os_ * t for t in (dx1, dx2, dw, dv))
            dos = None if dos is None else dos.reshape(os_.shape).to(os_.dtype)
        return dx1, dx2, dw.reshape(w.shape), dv, dos, None, None


def fused_periodic_matvec(x1p: torch.Tensor, x2p: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                          symmetric: bool = False, grad_only: bool = False) -> torch.Tensor:
    """out = K(x1p, x2p) @ v for the periodic kernel, never materialising K; differentiable.

    x1p: (n, d) and x2p: (m, d), the inputs divided by the period; w: (d,), the weights
    1/ℓ²; v: (m, t) → (n, t).  CPU tensors take the plain versions; CUDA tensors launch
    the CUDA kernels (float32, contiguous) or raise.

    ``symmetric``: x1p and x2p are one tensor, so the backward is the one fused pass
    (``csrc/kernel_periodic_bwd_fused.cu``) that returns the whole cotangent of that tensor
    and dw; dv, where asked for, is one more product K·g.  Otherwise the backward is the
    plain general one.  ``grad_only``: the caller uses the product only for its gradient;
    the forward returns zeros and launches nothing (the JAX package computes that unused
    value)."""
    _check_shapes(x1p, x2p, w, v)
    _check_symmetric(x1p, x2p, symmetric)
    return _PeriodicMatvec.apply(x1p, x2p, w, v, None, bool(symmetric), bool(grad_only))


def fused_scaled_periodic_matvec(x1p, x2p, w, v, outputscale, symmetric: bool = False,
                                 grad_only: bool = False) -> torch.Tensor:
    """out = outputscale · K(x1p, x2p) @ v, with the outputscale an operand of its own.

    Its value is ``fused_periodic_matvec(x1p, x2p, w, outputscale · v)``.  Its gradient
    reads the outputscale's cotangent ½ Σ_ij K_ij GG_ij out of the fused symmetric backward
    (the general backward: Σ g ⊙ (K v), one product), and not through dv = K·g, which the
    training backward never needs.  The JAX package folds the outputscale into the
    right-hand side and takes its gradient through dv
    (``gpytorch_tpu/linop/lazy_kernel.py:201-206``); the port does as the JAX package's RBF
    path does (``fused_kernels.py::fused_scaled_kernel_matvec``)."""
    _check_shapes(x1p, x2p, w, v)
    _check_symmetric(x1p, x2p, symmetric)
    outputscale = torch.as_tensor(outputscale, dtype=v.dtype, device=v.device)
    return _PeriodicMatvec.apply(x1p, x2p, w, v, outputscale, bool(symmetric), bool(grad_only))
