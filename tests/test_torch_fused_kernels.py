"""The port's fused kernel matvec (gpytorch_tpu_torch/ops/fused_kernels.py) against the
JAX package's: the Pallas kernel in interpret mode, and its jnp reference path.

On the CPU the dispatch takes the plain PyTorch version; the CUDA kernel itself is checked
against that plain version on a GPU by tests/test_torch_cuda_kernel.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _data(n, m, d, t, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(dtype) for s in ((n, d), (m, d), (m, t)))


def _port(x1, x2, v, ktype, **kw):
    return fk._matvec_reference(torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(v), ktype, **kw).numpy()


def test_kernel_ids_match_the_jax_package():
    assert (fk.RBF, fk.MATERN05, fk.MATERN15, fk.MATERN25) == (pk.RBF, pk.MATERN05, pk.MATERN15, pk.MATERN25)


@pytest.mark.parametrize("ktype,d", [pytest.param(k, 3, id=str(k)) for k in KERNEL_TYPES]
                         + [pytest.param(k, 100, id=f"{k}-d100") for k in KERNEL_TYPES])
def test_plain_matches_pallas_kernel_interpret(ktype, d, pallas_interpret_small_tiles):
    # float32, ragged: 137 rows = 2 row tiles, 251 columns = 1 padded column tile.  d = 100
    # (the Pallas kernel's quadratic-expansion path, past 8 dims): 40 × 70, the inputs
    # scaled by 1/√d so that K is not all 0; the same tolerance
    if d == 3:
        x1, x2, v = _data(137, 251, 3, 5, seed=ktype, dtype=np.float32)
    else:
        x1, x2, v = _data(40, 70, d, 5, seed=ktype, dtype=np.float32)
        x1, x2 = x1 / np.float32(np.sqrt(d)), x2 / np.float32(np.sqrt(d))
    want = np.asarray(pk._matvec_pallas(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v), ktype))
    np.testing.assert_allclose(_port(x1, x2, v, ktype), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ktype", KERNEL_TYPES)
def test_plain_matches_jax_reference_float64(ktype):
    # gpytorch_tpu's sq_dist forms its distance product with preferred_element_type=float32
    # even under x64.  Inputs on a quarter grid with a power-of-two row count keep every
    # entry and partial sum of that product exact in float32, so both sides see the same
    # distances and agree to float64 round-off.
    rng = np.random.default_rng(10 + ktype)
    x1 = rng.integers(-6, 7, size=(64, 3)) / 4.0
    x2 = rng.integers(-6, 7, size=(75, 3)) / 4.0
    v = rng.normal(size=(75, 4))
    want = np.asarray(pk._matvec_reference(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v), ktype))
    np.testing.assert_allclose(_port(x1, x2, v, ktype), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("chunk", [1, 64, 299, 300, 4096])
def test_plain_row_chunking(chunk):
    x1, x2, v = _data(300, 200, 3, 3, seed=7)
    d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1)
    exact = np.exp(-0.5 * d2) @ v
    np.testing.assert_allclose(_port(x1, x2, v, fk.RBF, chunk=chunk), exact, rtol=1e-10, atol=1e-12)


def test_dispatch_takes_plain_version_on_cpu():
    x1, x2, v = (torch.from_numpy(a) for a in _data(30, 20, 2, 2, seed=3))
    before = fk.kernel_matvec_cuda.launches
    out = fk.fused_scaled_kernel_matvec(x1, x2, v, torch.tensor(0.7, dtype=torch.float64), fk.MATERN25)
    torch.testing.assert_close(out, 0.7 * fk._matvec_reference(x1, x2, v, fk.MATERN25), rtol=1e-12, atol=1e-12)
    assert fk.kernel_matvec_cuda.launches == before


def _f32(*shapes):
    return tuple(torch.zeros(s, dtype=torch.float32) for s in shapes)


@pytest.mark.parametrize(
    "args,error",
    [
        (tuple(torch.zeros(s, dtype=torch.float64) for s in ((4, 3), (5, 3), (5, 2))), TypeError),  # dtype
        (_f32((4, 3), (5, 2), (5, 2)), ValueError),  # d of x1 and x2 differ
        (_f32((4, 3), (5, 3), (6, 2)), ValueError),  # rows of x2 and v differ
        (_f32((4, 3), (5, 3), (5,)), ValueError),  # v not 2-D
        (_f32((4, 3), (5, 3), (5, 2)), ValueError),  # a CPU tensor
    ],
)
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(args, error):
    before = fk.kernel_matvec_cuda.launches
    with pytest.raises(error):
        fk.kernel_matvec_cuda(*args, fk.RBF)
    assert fk.kernel_matvec_cuda.launches == before


@pytest.mark.parametrize("ktype", [-1, 4])
def test_unknown_kernel_type_raises(ktype):
    with pytest.raises(ValueError):
        fk.fused_kernel_matvec(*_f32((4, 3), (5, 3), (5, 2)), ktype)


def test_dispatch_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        fk.fused_kernel_matvec(*_f32((4, 3), (5, 3), (6, 2)), fk.RBF)
