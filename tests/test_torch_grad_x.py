"""The cotangent of one input of the kernel product (gpytorch_tpu_torch/ops/fused_kernels.py:
``_grad_x_reference`` and the asymmetric branch of the autograd Functions) against the JAX
package's: ``_grad_x_pallas`` in interpret mode, ``jax.grad`` of the dense product, and
``jax.vjp`` of the custom-VJP products on their reference branch.

On the CPU the Functions take the plain versions; the CUDA kernel itself
(csrc/kernel_grad_x.cu) is checked against the plain version on a GPU by
tests/test_torch_cuda_kernel.py and chip_smoke.py.
"""

import sys

import jax
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


def _arrays(seed, *shapes, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(dtype) for s in shapes)


def _t(*arrays, grad=False):
    return tuple(torch.from_numpy(a).requires_grad_(grad) for a in arrays)


# ---------------------------------------------------------------------------------------
# the plain version against the Pallas kernel and against jax.grad
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("ktype", KERNEL_TYPES)
@pytest.mark.parametrize("n,m,d,t", [pytest.param(140, 300, 3, 5, id="140-300-5"), pytest.param(300, 90, 3, 40, id="300-90-40"),
                                     pytest.param(40, 70, 100, 5, id="40-70-d100-5")])
def test_plain_grad_x_matches_pallas_kernel_interpret(ktype, n, m, d, t, pallas_interpret_small_tiles):
    # float32, ragged both ways (n ≪ m, n ≫ m) over several tiles, t > 32 in the second
    # case, and d = 100 (the Pallas kernel's quadratic-expansion path; inputs scaled by 1/√d
    # so that K is not all 0); the tolerance of tests/test_pallas_interpret.py's grad_x
    # cases (2e-4)
    x1, x2, g, v = _arrays(20 + ktype, (n, d), (m, d), (n, t), (m, t), dtype=np.float32)
    if d > 3:
        x1, x2 = x1 / np.float32(np.sqrt(d)), x2 / np.float32(np.sqrt(d))
    want = pk._grad_x_pallas(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(g), jnp.asarray(v), ktype)
    got = fk._grad_x_reference(*_t(x1, x2, g, v), ktype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("ktype", KERNEL_TYPES)
@pytest.mark.parametrize("n,m,d,t", [(37, 90, 3, 1), (90, 23, 11, 45)])
def test_plain_grad_x_matches_jax_grad_float64(ktype, n, m, d, t):
    # against jax.grad of Σ g ⊙ (K(x1, x2) v) with K formed densely from direct differences
    x1, x2, g, v = _arrays(30 + ktype, (n, d), (m, d), (n, t), (m, t))

    def dense(a):
        d2 = jnp.sum((a[:, None, :] - x2[None, :, :]) ** 2, axis=-1)
        return jnp.sum(g * (pk._kernel_fn(d2, ktype) @ v))

    want = jax.jit(jax.grad(dense))(jnp.asarray(x1))
    got = fk._grad_x_reference(*_t(x1, x2, g, v), ktype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("chunk", [7, 29, 4096])
def test_plain_grad_x_row_chunking(chunk):
    x1, x2, g, v = _t(*_arrays(3, (60, 2), (45, 2), (60, 3), (45, 3)))
    torch.testing.assert_close(fk._grad_x_reference(x1, x2, g, v, fk.MATERN15, chunk=chunk),
                               fk._grad_x_reference(x1, x2, g, v, fk.MATERN15), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("ktype", KERNEL_TYPES)
def test_coincident_pair_adds_exactly_zero(ktype):
    # a row of x2 equal to the row of x1 adds nothing, even where Matérn-½'s k′(0) is
    # −0.5/√1e-30: the moment is formed from per-pair differences
    x1, x2, g, v = _arrays(4, (3, 2), (5, 2), (3, 2), (5, 2))
    far = x2 + 1000.0  # k′ underflows to 0 for every other pair at this distance
    far[2] = x1[1]
    got = fk._grad_x_reference(*_t(x1, far, g, v), ktype)
    assert torch.count_nonzero(got[1]) == 0


# ---------------------------------------------------------------------------------------
# the asymmetric branch of the autograd Functions
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("ktype", KERNEL_TYPES)
def test_asymmetric_branch_matches_jax_reference_vjp(ktype):
    # all four cotangents of the scaled product against jax.vjp of the JAX package's
    # fused_scaled_kernel_matvec, whose CPU backward is the general (non-Pallas) branch of
    # _fskm_bwd; distances there come from the expansion in float32 (sq_dist), so direct
    # differences are patched in for a float64 comparison
    x1, x2, v, g = _arrays(40 + ktype, (50, 3), (70, 3), (70, 33), (50, 33))
    os_ = np.array(1.3)
    dense_d2 = lambda a, b, x1_eq_x2=False: jnp.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys.modules["gpytorch_tpu.ops.sq_dist"], "sq_dist", dense_d2)
        out_j, vjp = jax.vjp(lambda a, b, v_, o: pk.fused_scaled_kernel_matvec(a, b, v_, o, ktype),
                             jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(v), jnp.asarray(os_))
        want = vjp(jnp.asarray(g))
    a, b, v_t, o = _t(x1, x2, v, os_, grad=True)
    out = fk.fused_scaled_kernel_matvec(a, b, v_t, o, ktype)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-9, atol=1e-12)
    for got, w, name in zip((a.grad, b.grad, v_t.grad, o.grad), want, ("dx1", "dx2", "dv", "dos")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-9, atol=1e-10 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("scaled,wrt", [(False, ("x1",)), (False, ("x1", "x2")), (False, ("x1", "v")),
                                        (True, ("x1",)), (True, ("x1", "x2", "v")), (True, ("x1", "os"))])
def test_asymmetric_branch_runs_only_the_passes_asked_for(scaled, wrt, monkeypatch):
    # each output of the backward comes from its own pass, and only where autograd asks:
    # dx1 and dx2 one _grad_x each (dx2 with the roles swapped), dv one product K(x2, x1) g
    # and dos one product K(x1, x2) v
    calls = []
    grad_x, product = fk._grad_x, fk._product
    monkeypatch.setattr(fk, "_grad_x", lambda *args: calls.append(("grad_x", args[0].shape[0])) or grad_x(*args))
    x1, x2, v, g = _arrays(50, (20, 2), (30, 2), (30, 4), (20, 4))
    a, b, v_t, o = (torch.from_numpy(arr).requires_grad_(name in wrt)
                    for arr, name in zip((x1, x2, v, np.array(0.7)), ("x1", "x2", "v", "os")))
    out = fk.fused_scaled_kernel_matvec(a, b, v_t, o, fk.RBF) if scaled else fk.fused_kernel_matvec(a, b, v_t, fk.RBF)
    monkeypatch.setattr(fk, "_product", lambda *args: calls.append(("product", args[0].shape[0])) or product(*args))
    out.backward(torch.from_numpy(g))
    want = [("product", 30)] if "v" in wrt else []
    want += [("product", 20)] if "os" in wrt else []
    want += [("grad_x", 20)] + ([("grad_x", 30)] if "x2" in wrt else [])
    assert calls == want
    assert (b.grad is None) == ("x2" not in wrt)
