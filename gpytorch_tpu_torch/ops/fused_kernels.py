"""Streaming products with a stationary kernel matrix K(x1, x2), and their gradients — the
hot operations of exact-GP serving and training.

Counterpart of ``gpytorch_tpu/ops/pallas_kernels.py``.  What lives here:

* the kernel functions of squared distance (``_kernel_fn``, ``_kernel_prime`` and
  ``_kernel_fn_and_prime``, which shares one exp between k and k′);
* the plain PyTorch versions, streamed in blocks of rows so that K is never held whole,
  even at N=100k: the product ``_matvec_reference``, the cotangent of one input
  ``_grad_x_reference`` and the fused symmetric backward ``_bwd_fused_reference``;
* the hand-written CUDA kernels ``csrc/kernel_matvec.cu`` (K·V), ``csrc/kernel_grad_x.cu``
  (the cotangent of one input) and ``csrc/kernel_bwd_fused.cu`` (the symmetric backward:
  dx and dos; dv, where asked for, is one K·V), bound by ctypes;
* the build of every CUDA source of the package (these three and the periodic pair of
  ``ops/periodic_kernels.py``) with nvcc at first use into one library;
* the differentiable products ``fused_kernel_matvec`` and ``fused_scaled_kernel_matvec``
  (``torch.autograd.Function``s).  CPU tensors take the plain versions; CUDA tensors
  launch the CUDA kernels or raise — there is no fallback.

All inputs are pre-scaled: the caller centres x and divides it by the lengthscale.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import math
import os
import subprocess
from pathlib import Path

import torch

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)

# kernel ids, as in gpytorch_tpu/ops/pallas_kernels.py
RBF = 0
MATERN05 = 1
MATERN15 = 2
MATERN25 = 3
KERNEL_TYPES = (RBF, MATERN05, MATERN15, MATERN25)

# rows per block of the plain streamed versions (gpytorch_tpu/linop/lazy_kernel.py:24)
_CHUNK = 4096


def _kernel_fn(d2: torch.Tensor, kernel_type: int) -> torch.Tensor:
    if kernel_type == RBF:
        return torch.exp(-0.5 * d2)
    r = torch.sqrt(torch.clamp_min(d2, 1e-30))
    if kernel_type == MATERN05:
        return torch.exp(-r)
    if kernel_type == MATERN15:
        s = _SQRT3 * r
        return (1.0 + s) * torch.exp(-s)
    s = _SQRT5 * r
    return (1.0 + s + s * s / 3.0) * torch.exp(-s)


def _kernel_prime(d2: torch.Tensor, kernel_type: int) -> torch.Tensor:
    """dk/d(d2)."""
    if kernel_type == RBF:
        return -0.5 * torch.exp(-0.5 * d2)
    r = torch.sqrt(torch.clamp_min(d2, 1e-30))
    if kernel_type == MATERN05:
        return -torch.exp(-r) * (0.5 / r)
    if kernel_type == MATERN15:
        return -1.5 * torch.exp(-_SQRT3 * r)
    return -(5.0 / 6.0) * (1.0 + _SQRT5 * r) * torch.exp(-_SQRT5 * r)


def _kernel_fn_and_prime(d2: torch.Tensor, kernel_type: int):
    """(k(d2), dk/d(d2)) sharing one exp: every supported k′ is a rational factor times
    the same exponential as k."""
    if kernel_type == RBF:
        k = torch.exp(-0.5 * d2)
        return k, -0.5 * k
    r = torch.sqrt(torch.clamp_min(d2, 1e-30))
    if kernel_type == MATERN05:
        k = torch.exp(-r)
        return k, -k * (0.5 / r)
    if kernel_type == MATERN15:
        s = _SQRT3 * r
        e = torch.exp(-s)
        return (1.0 + s) * e, -1.5 * e
    s = _SQRT5 * r
    e = torch.exp(-s)
    return (1.0 + s + s * s / 3.0) * e, -(5.0 / 6.0) * (1.0 + s) * e


def _check_shapes(x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor, kernel_type: int) -> None:
    if kernel_type not in KERNEL_TYPES:
        raise ValueError(f"kernel_type must be one of {KERNEL_TYPES}, got {kernel_type!r}")
    if x1.ndim != 2 or x2.ndim != 2 or v.ndim != 2:
        raise ValueError(f"expected x1 (n, d), x2 (m, d), v (m, t); got {tuple(x1.shape)}, {tuple(x2.shape)}, {tuple(v.shape)}")
    if x1.shape[1] != x2.shape[1] or x2.shape[0] != v.shape[0]:
        raise ValueError(f"shape mismatch: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}, v {tuple(v.shape)}")


def _matvec_reference(x1, x2, v, kernel_type: int, chunk: int = _CHUNK) -> torch.Tensor:
    """Plain PyTorch K(x1, x2)·v, by blocks of ``chunk`` rows of x1.

    Distances use the quadratic expansion centred once on x1's mean
    (``gpytorch_tpu/ops/pallas_kernels.py::_matvec_reference``); each block holds one
    (chunk, m) slice of K."""
    from .sq_dist import sq_dist_centered

    _check_shapes(x1, x2, v, kernel_type)
    center = x1.mean(-2, keepdim=True)
    x1c, x2c = x1 - center, x2 - center
    out = torch.empty((x1.shape[0], v.shape[1]), dtype=torch.result_type(x1, v), device=v.device)
    for i in range(0, x1.shape[0], chunk):
        k = _kernel_fn(sq_dist_centered(x1c[i : i + chunk], x2c), kernel_type)
        torch.matmul(k, v, out=out[i : i + chunk])
    return out


def _grad_x_reference(x1, x2, g, v, kernel_type: int, chunk: int = _CHUNK) -> torch.Tensor:
    """Plain dx1 = 2 Σ_j k′(d2_ij)(g_i·v_j)(x1_i − x2_j), the cotangent of x1 in
    Σ g ⊙ (K(x1, x2) v), by blocks of ``chunk`` rows of x1; dx2 is
    ``_grad_x_reference(x2, x1, v, g)``.

    Counterpart of ``gpytorch_tpu/ops/pallas_kernels.py::_grad_x_pallas`` and the CUDA
    kernel's twin: distances and the moment come from per-pair differences, one input dim
    at a time, and not from rowsum(W)·x1 − W·x2, so that a coincident pair adds exactly 0
    (Matérn-½'s k′(0) ~ 1/√1e-30 would otherwise multiply round-off)."""
    _check_shapes(x1, x2, v, kernel_type)
    if g.shape != (x1.shape[0], v.shape[1]):
        raise ValueError(f"g {tuple(g.shape)} must be (rows of x1, columns of v) = {(x1.shape[0], v.shape[1])}")
    d = x1.shape[1]
    dx1 = torch.empty(x1.shape, dtype=torch.result_type(x1, g), device=x1.device)
    for i in range(0, x1.shape[0], chunk):
        a = x1[i : i + chunk]
        d2 = sum((a[:, k, None] - x2[None, :, k]) ** 2 for k in range(d))
        W = _kernel_prime(d2, kernel_type) * (g[i : i + chunk] @ v.mT)
        for k in range(d):
            dx1[i : i + chunk, k] = 2.0 * (W * (a[:, k, None] - x2[None, :, k])).sum(-1)
    return dx1


def _bwd_fused_reference(x, g, v, kernel_type: int, need_dv: bool = True, need_dos: bool = False,
                         chunk: int = _CHUNK):
    """Plain version of the fused symmetric backward (the CUDA kernel's twin): for
    out = K(x, x) v and the cotangent g, (dv, dx, dos) with
    dv = K g, dx = 2 Σ_j k′(d2_ij)(g_i·v_j + v_i·g_j)(x_i − x_j) (k′ zeroed on the exact
    diagonal) and dos = Σ_ij k(d2_ij)(g_i·v_j); dv and dos are ``None`` unless asked for.
    Streamed by blocks of rows, as ``gpytorch_tpu/ops/pallas_kernels.py::_bwd_fused_pallas``
    computes it by tiles.  dv is K g from the same blocks of K, whose diagonal is exact, as
    the CUDA product kernel's is (direct differences) where the CUDA wrapper takes dv from
    it; ``_matvec_reference`` keeps the expansion's round-off there, which Matérn-½'s
    e^(−√d2) turns into up to 1e-3 of K_ii in float32."""
    from .sq_dist import sq_dist_centered

    _check_shapes(x, x, v, kernel_type)
    if g.shape != v.shape:
        raise ValueError(f"g {tuple(g.shape)} and v {tuple(v.shape)} differ")
    xc = x - x.mean(-2, keepdim=True)
    n = x.shape[0]
    dx = torch.empty_like(xc)
    dv = torch.empty_like(v) if need_dv else None
    dos = torch.zeros((), dtype=v.dtype, device=v.device) if need_dos else None
    for i in range(0, n, chunk):
        a, gb, vb = xc[i : i + chunk], g[i : i + chunk], v[i : i + chunk]
        # the exact diagonal: d2 = 0 (the expansion leaves round-off there, which the
        # Matérn kernels' square root amplifies) and k′ = 0
        d2 = sq_dist_centered(a, xc)
        rows = torch.arange(a.shape[0], device=x.device)
        d2[rows, rows + i] = 0.0
        k, kp = _kernel_fn_and_prime(d2, kernel_type)
        kp[rows, rows + i] = 0.0
        gv = gb @ v.mT
        W = kp * (gv + vb @ g.mT)
        dx[i : i + chunk] = 2.0 * (W.sum(-1, keepdim=True) * a - W @ xc)
        if need_dv:
            dv[i : i + chunk] = k @ g
        if need_dos:
            dos = dos + (k * gv).sum()
    return dv, dx, dos


# ----------------------------------------------------------------------------------------
# the CUDA kernels: built from csrc/*.cu with nvcc at first use, bound by ctypes
# ----------------------------------------------------------------------------------------

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = tuple(
    _PKG / "csrc" / f"{name}.cu"
    for name in ("kernel_matvec", "kernel_grad_x", "kernel_bwd_fused", "kernel_periodic_matvec",
                 "kernel_periodic_bwd_fused")
)
_HEADERS = tuple(_PKG / "csrc" / name for name in ("periodic_common.cuh", "tc_common.cuh", "wide_d.cuh"))
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found: set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """Where the built kernel library lives: named by a hash of its sources, headers and
    flags, so an edited source is rebuilt and an unchanged one is reused."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _SOURCES + _HEADERS:
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libgp_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the CUDA sources for sm_90a into one shared library unless it exists.

    Each source is compiled by its own nvcc process, all started together, and the
    objects are then linked.  Raises ``RuntimeError`` with nvcc's output on failure."""
    so = library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [_BUILD_DIR / f"{tag}.{src.stem}.o" for src in _SOURCES]
    cmds = [[_nvcc(), *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(_SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = _BUILD_DIR / f"{tag}.tmp"
    cmd = [_nvcc(), *_NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink()
    return so


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached for the process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gp_kernel_matvec_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.gp_kernel_matvec_f32.restype = ctypes.c_int
        lib.gp_kernel_grad_x_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.gp_kernel_grad_x_f32.restype = ctypes.c_int
        lib.gp_kernel_grad_x_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.gp_kernel_grad_x_plan.restype = ctypes.c_int
        lib.gp_kernel_bwd_fused_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.gp_kernel_bwd_fused_f32.restype = ctypes.c_int
        lib.gp_kernel_bwd_fused_chunks.argtypes = [ctypes.c_int] * 2
        lib.gp_kernel_bwd_fused_chunks.restype = ctypes.c_int
        lib.gp_periodic_matvec_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.gp_periodic_matvec_f32.restype = ctypes.c_int
        lib.gp_kernel_matvec_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.gp_kernel_matvec_plan.restype = ctypes.c_int
        lib.gp_periodic_matvec_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        lib.gp_periodic_matvec_plan.restype = ctypes.c_int
        lib.gp_periodic_bwd_fused_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.gp_periodic_bwd_fused_f32.restype = ctypes.c_int
        lib.gp_periodic_bwd_fused_chunks.argtypes = [ctypes.c_int]
        lib.gp_periodic_bwd_fused_chunks.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda_f32(**tensors) -> None:
    devices = set()
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the CUDA kernel, got {t.dtype}")
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devices))}")


# ----------------------------------------------------------------------------------------
# slabs of the j range: how a kernel whose grid is too small for the card is split
# ----------------------------------------------------------------------------------------

def _slab_count(row_blocks: int, chunks: int, m: int, sm_count: int, blocks_per_sm: int, min_slab: int,
                tile: int) -> int:
    """How many slabs of the j range (the rows of x2) a kernel's grid is split into.  Only a
    grid of fewer row blocks × column chunks than the card's ``sm_count`` SMs (a strip) is
    split, so that a grid that fills the card alone keeps one slab and its sums; it is split
    as far as one wave of ``blocks_per_sm`` blocks on every SM (rounded down: a block past
    the wave costs a whole block's time; ``chip_smoke.slab_sweep`` times the strips by slab
    count), with at least ``min_slab`` rows j in a slab and at most 65535 slabs (grid.z).
    The kernel's C entry makes each slab ceil(m / slabs) rows rounded up to a multiple of its
    staged ``tile``; the count is trimmed so that no slab lies past m.  Each slab writes its
    own partial, which the wrapper folds with ``torch.sum``."""
    grid = row_blocks * chunks
    if grid >= sm_count:
        return 1
    slabs = max(1, min(blocks_per_sm * sm_count // grid, m // min_slab, 65535))
    per_slab = -(-m // slabs)
    length = -(-per_slab // tile) * tile
    return -(-m // length) if length else 1


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# least rows j in a slab of a split launch
_MIN_SLAB = 256


@functools.lru_cache(maxsize=1024)
def _launch_plan(entry: str, device_index: int, *sizes: int) -> tuple[int, int, int, int]:
    """What a streaming kernel's C entry would launch at these sizes (``gp_kernel_matvec_plan``,
    ``gp_periodic_matvec_plan`` or ``gp_kernel_grad_x_plan``): row blocks, column chunks, the
    tier's blocks that fit on an SM at once (CUDA's occupancy calculator, from the kernel's
    registers and shared memory) and the staged tile of rows j that a slab is a multiple of."""
    plan = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        rc = getattr(load_library(), entry)(*sizes, plan)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")
    return tuple(plan)


def product_slabs(entry: str, device: torch.device, m: int, *sizes: int) -> int:
    """The slab count of one launch of a streaming kernel: ``_slab_count`` of the grid that
    ``entry`` plans at ``sizes``, splitting only a grid below the card's SM count (one wave),
    with at least ``_MIN_SLAB`` rows j a slab.  A strip of 2048 or 256 rows against 100k
    splits; a 100k-row launch (782 row blocks) keeps one slab."""
    row_blocks, chunks, per_sm, tile = _launch_plan(entry, device.index, *sizes)
    return _slab_count(row_blocks, chunks, m, _sm_count(device), per_sm, _MIN_SLAB, tile)


class KernelMatvecCUDA:
    """Wrapper of the K·V kernel: checks its inputs, chooses the slab split
    (``product_slabs``), allocates the output (the per-slab partials where there is more
    than one slab, folded with ``torch.sum``), launches on the current stream, counts its
    launches in ``launches`` (and by kernel type in ``launches_by_type``) and keeps the last
    launch's slab count in ``last_slabs``."""

    def __init__(self):
        self.launches = 0
        self.launches_by_type = collections.Counter()
        self.last_slabs = 0

    def __call__(self, x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor, kernel_type: int) -> torch.Tensor:
        _check_shapes(x1, x2, v, kernel_type)
        _check_cuda_f32(x1=x1, x2=x2, v=v)
        n, d = x1.shape
        m, t = v.shape
        if n == 0 or t == 0:
            return torch.empty((n, t), dtype=torch.float32, device=x1.device)
        slabs = product_slabs("gp_kernel_matvec_plan", x1.device, m, n, d, t, int(kernel_type))
        out = torch.empty((slabs, n, t), dtype=torch.float32, device=x1.device)
        lib = load_library()
        with torch.cuda.device(x1.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gp_kernel_matvec_f32(
                x1.data_ptr(), x2.data_ptr(), v.data_ptr(), out.data_ptr(), n, m, d, t, int(kernel_type), slabs, stream
            )
        if rc != 0:
            raise RuntimeError(f"kernel_matvec launch failed: CUDA error {rc}")
        self.launches += 1
        self.launches_by_type[int(kernel_type)] += 1
        self.last_slabs = slabs
        return out[0] if slabs == 1 else out.sum(0)


kernel_matvec_cuda = KernelMatvecCUDA()

def grad_x_slabs(device: torch.device, n: int, m: int, d: int, t: int, kernel_type: int) -> int:
    """The slab count of one grad_x launch: ``product_slabs`` of the tier that
    ``gp_kernel_grad_x_plan`` reports.  A 2048-row strip against 100k rows splits as far as
    one wave; a 100k-row side (dx2) keeps one slab."""
    return product_slabs("gp_kernel_grad_x_plan", device, m, n, d, t, int(kernel_type))


class KernelGradXCUDA:
    """Wrapper of the asymmetric backward kernel: returns dx1 as ``_grad_x_reference``
    does.  Takes the column chunks of the tier and the slab split (``grad_x_slabs``) from the
    kernel's C plan, allocates the per-(slab, chunk) partials, launches on the current
    stream, folds them with ``torch.sum``, counts its launches in ``launches`` and keeps the
    last launch's slab count in ``last_slabs``."""

    def __init__(self):
        self.launches = 0
        self.last_slabs = 0

    def __call__(self, x1, x2, g, v, kernel_type: int) -> torch.Tensor:
        _check_shapes(x1, x2, v, kernel_type)
        if g.shape != (x1.shape[0], v.shape[1]):
            raise ValueError(f"g {tuple(g.shape)} must be (rows of x1, columns of v) = {(x1.shape[0], v.shape[1])}")
        _check_cuda_f32(x1=x1, x2=x2, g=g, v=v)
        n, d = x1.shape
        m, t = v.shape
        if n == 0 or m == 0 or t == 0:
            return torch.zeros_like(x1)
        chunks = _launch_plan("gp_kernel_grad_x_plan", x1.device.index, n, d, t, int(kernel_type))[1]
        slabs = grad_x_slabs(x1.device, n, m, d, t, kernel_type)
        dx_part = torch.empty((slabs * chunks, n, d), dtype=torch.float32, device=x1.device)
        lib = load_library()
        with torch.cuda.device(x1.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gp_kernel_grad_x_f32(
                x1.data_ptr(), x2.data_ptr(), g.data_ptr(), v.data_ptr(), dx_part.data_ptr(), n, m, d, t,
                int(kernel_type), slabs, stream,
            )
        if rc != 0:
            raise RuntimeError(f"kernel_grad_x launch failed: CUDA error {rc}")
        self.launches += 1
        self.last_slabs = slabs
        return dx_part[0] if slabs * chunks == 1 else dx_part.sum(0)


kernel_grad_x_cuda = KernelGradXCUDA()

class KernelBwdFusedCUDA:
    """Wrapper of the fused symmetric backward kernel: returns (dv, dx, dos) as
    ``_bwd_fused_reference`` does.  Allocates the per-chunk per-row dx and dos partials (as
    many chunks as the library says), launches on the current stream, folds the partials
    with ``torch.sum`` (dos's in ``dos_fold_dtype``, float64) and counts its launches in
    ``launches`` (and by kernel type in ``launches_by_type``).  The kernel forms no dv: where
    it is asked for, dv = K·g is one launch of the product kernel (counted by
    ``kernel_matvec_cuda``).  On the tensor-core tier (t in (32, 64], d ≤ 64) the library
    forms dos in float64 in a second kernel of the same launch (``kernel_bwd_dos64``), whose
    per-row partials are rounded to float32 once."""

    def __init__(self):
        self.launches = 0
        self.launches_by_type = collections.Counter()
        self.dos_fold_dtype = torch.float64

    def __call__(self, x, g, v, kernel_type: int, need_dv: bool = True, need_dos: bool = False):
        _check_shapes(x, x, v, kernel_type)
        if g.shape != v.shape:
            raise ValueError(f"g {tuple(g.shape)} and v {tuple(v.shape)} differ")
        _check_cuda_f32(x=x, g=g, v=v)
        n, d = x.shape
        t = v.shape[1]
        dev = x.device
        if n == 0 or t == 0:
            dos = torch.zeros((), dtype=torch.float32, device=dev) if need_dos else None
            return (torch.zeros_like(v) if need_dv else None), torch.zeros_like(x), dos
        lib = load_library()
        chunks = lib.gp_kernel_bwd_fused_chunks(t, d)
        dx_part = torch.empty((chunks, n, d), dtype=torch.float32, device=dev)
        dos_part = torch.empty((chunks, n), dtype=torch.float32, device=dev) if need_dos else None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gp_kernel_bwd_fused_f32(
                x.data_ptr(), g.data_ptr(), v.data_ptr(), dx_part.data_ptr(), dos_part.data_ptr() if need_dos else None,
                n, d, t, int(kernel_type), int(need_dos), stream,
            )
        if rc != 0:
            raise RuntimeError(f"kernel_bwd_fused launch failed: CUDA error {rc}")
        self.launches += 1
        self.launches_by_type[int(kernel_type)] += 1
        dv = kernel_matvec_cuda(x, x, g, kernel_type) if need_dv else None
        dx = dx_part[0] if chunks == 1 else dx_part.sum(0)
        # dos's n per-row partials cancel to a small sum: folded in float64, the fold adds
        # no float32 rounding of its own (the partials' own rounding stays, ≈ 1e-7 of |dos|)
        return dv, dx, (dos_part.sum(dtype=self.dos_fold_dtype).to(torch.float32) if need_dos else None)


kernel_bwd_fused_cuda = KernelBwdFusedCUDA()


# ----------------------------------------------------------------------------------------
# dispatch and the differentiable products
# ----------------------------------------------------------------------------------------

def _product(x1, x2, v, kernel_type: int) -> torch.Tensor:
    if x1.is_cuda:
        return kernel_matvec_cuda(x1, x2, v, kernel_type)
    if x1.device.type != "cpu":
        raise ValueError(f"unsupported device {x1.device}")
    return _matvec_reference(x1, x2, v, kernel_type)


def _grad_x(x1, x2, g, v, kernel_type: int) -> torch.Tensor:
    if x1.is_cuda:
        return kernel_grad_x_cuda(x1, x2, g, v, kernel_type)
    if x1.device.type != "cpu":
        raise ValueError(f"unsupported device {x1.device}")
    return _grad_x_reference(x1, x2, g, v, kernel_type)


def _backward(x1, x2, g, v, kernel_type: int, symmetric: bool, need_dv: bool, need_dos: bool,
              need_dx1: bool = True, need_dx2: bool = True):
    """(dv, dx1, dx2, dos) of Σ g ⊙ (K(x1, x2) v); each is ``None`` where not needed.

    Symmetric (x1 and x2 one tensor): one fused pass, and the whole cotangent of that
    tensor comes back in dx1 — the CUDA kernel on the card, its plain twin on the CPU.
    Asymmetric: the general branch of ``gpytorch_tpu/ops/pallas_kernels.py::_fkm_bwd``
    and ``_fskm_bwd``, one pass for each output asked for: dv = K(x2, x1) g and
    dos = Σ g ⊙ (K v) by the product, dx1 and dx2 by ``_grad_x`` (dx2 with the roles of
    (x1, g) and (x2, v) swapped), each a CUDA kernel on the card and its plain version on
    the CPU."""
    g = g.contiguous()
    if symmetric:
        if x1.is_cuda:
            dv, dx, dos = kernel_bwd_fused_cuda(x1, g, v, kernel_type, need_dv=need_dv, need_dos=need_dos)
        elif x1.device.type == "cpu":
            dv, dx, dos = _bwd_fused_reference(x1, g, v, kernel_type, need_dv=need_dv, need_dos=need_dos)
        else:
            raise ValueError(f"unsupported device {x1.device}")
        return dv, dx, None, dos
    dv = _product(x2, x1, g, kernel_type) if need_dv else None
    dos = (g * _product(x1, x2, v, kernel_type)).sum() if need_dos else None
    dx1 = _grad_x(x1, x2, g, v, kernel_type) if need_dx1 else None
    dx2 = _grad_x(x2, x1, v, g, kernel_type) if need_dx2 else None
    return dv, dx1, dx2, dos


def _zeros_out(x1, v) -> torch.Tensor:
    return torch.zeros((x1.shape[0], v.shape[1]), dtype=torch.result_type(x1, v), device=v.device)


class _KernelMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, v, kernel_type, symmetric, grad_only):
        ctx.save_for_backward(x1, x2, v)
        ctx.kernel_type, ctx.symmetric = kernel_type, symmetric
        return _zeros_out(x1, v) if grad_only else _product(x1, x2, v, kernel_type)

    @staticmethod
    def backward(ctx, g):
        x1, x2, v = ctx.saved_tensors
        need = ctx.needs_input_grad
        dv, dx1, dx2, _ = _backward(x1, x2, g, v, ctx.kernel_type, ctx.symmetric, need[2], False, need[0], need[1])
        return dx1, dx2, dv, None, None, None


class _ScaledKernelMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, v, outputscale, kernel_type, symmetric, grad_only):
        ctx.save_for_backward(x1, x2, v, outputscale)
        ctx.kernel_type, ctx.symmetric = kernel_type, symmetric
        if grad_only:
            return _zeros_out(x1, v)
        # the product keeps v's memory layout, so it is made contiguous for the kernel; it
        # goes through the public entry, where the serving tests count every product
        return fused_kernel_matvec(x1, x2, (outputscale * v).contiguous(), kernel_type)

    @staticmethod
    def backward(ctx, g):
        x1, x2, v, os_ = ctx.saved_tensors
        need = ctx.needs_input_grad
        dv, dx1, dx2, dos = _backward(x1, x2, g, v, ctx.kernel_type, ctx.symmetric, need[2], need[3], need[0], need[1])
        scale = lambda t: None if t is None else os_ * t  # noqa: E731
        dos = None if dos is None else dos.reshape(os_.shape).to(os_.dtype)
        return scale(dx1), scale(dx2), scale(dv), dos, None, None, None


def _check_symmetric(x1, x2, symmetric: bool) -> None:
    if symmetric and x2 is not x1:
        raise ValueError("symmetric=True needs x1 and x2 to be one tensor")


def fused_kernel_matvec(x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor, kernel_type: int,
                        symmetric: bool = False, grad_only: bool = False) -> torch.Tensor:
    """out = K(x1, x2) @ v for pre-scaled inputs, never materialising K; differentiable.

    x1: (n, d); x2: (m, d); v: (m, t) → (n, t).  CPU tensors take the plain versions; CUDA
    tensors launch the CUDA kernels (float32, contiguous) or raise.

    ``symmetric``: x1 and x2 are one tensor, so the backward is the one fused pass
    (``csrc/kernel_bwd_fused.cu``) that returns the whole cotangent of that tensor.
    ``grad_only``: the caller uses the product only for its gradient (it is linear in
    it); the forward returns zeros and launches nothing — the counterpart of the JAX
    package's grad-only twins."""
    _check_shapes(x1, x2, v, kernel_type)
    _check_symmetric(x1, x2, symmetric)
    return _KernelMatvec.apply(x1, x2, v, kernel_type, bool(symmetric), bool(grad_only))


def fused_scaled_kernel_matvec(x1, x2, v, outputscale, kernel_type: int, symmetric: bool = False,
                               grad_only: bool = False) -> torch.Tensor:
    """out = outputscale · K(x1, x2) @ v, with the outputscale an operand of its own.

    Its value is ``fused_kernel_matvec(x1, x2, outputscale · v)``.  Its gradient reads
    the outputscale's cotangent Σ k(d2_ij)(g_i·v_j) out of the fused backward, and not
    through dv, which the training backward never needs (the JAX package's reason for
    the same operand, ``gpytorch_tpu/linop/lazy_kernel.py:212-216``)."""
    _check_shapes(x1, x2, v, kernel_type)
    _check_symmetric(x1, x2, symmetric)
    outputscale = torch.as_tensor(outputscale, dtype=v.dtype, device=v.device)
    return _ScaledKernelMatvec.apply(x1, x2, v, outputscale, kernel_type, bool(symmetric), bool(grad_only))


def kernel_type_for(kernel):
    """Map a kernel module to a fused-kernel id (None if unsupported), as
    ``gpytorch_tpu/ops/pallas_kernels.py::kernel_type_for`` does."""
    from ..kernels.stationary import MaternKernel, RBFKernel

    if type(kernel) is RBFKernel:
        return RBF
    if type(kernel) is MaternKernel:
        return {0.5: MATERN05, 1.5: MATERN15, 2.5: MATERN25}[kernel.nu]
    return None
