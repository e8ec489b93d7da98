"""Derivative-GP kernels: the covariances of function values and their derivatives.

Counterpart of ``gpytorch_tpu/kernels/grad_kernels.py``.  Each input contributes
``num_outputs_per_input`` consecutive rows, interleaved: [f, ∂₁f, …, ∂_d f] (and the
diagonal second derivatives ∂²_a f after them for ``RBFKernelGradGrad``), so that the
matrix of n inputs is (n·A) × (m·A), assembled from an A × A block of each pair of inputs
(``_interleave_blocks``).  Each block is a function of its pair alone; the diagonal is that
of the blocks of the pairs (x1_i, x2_i), as the JAX package takes it.  None takes
``last_dim_is_batch``, as in the JAX package.  None has a fused product: above
``max_eager_kernel_size``² the lazy operator streams K·V by blocks of inputs, A rows each.
"""

from __future__ import annotations

import math

import torch

from .linear_kernel import PolynomialKernel
from .stationary import MaternKernel, RBFKernel


def _interleave_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """blocks (…, n, m, A, B) → (…, n·A, m·B)."""
    b = blocks.transpose(-3, -2)  # (…, n, A, m, B)
    sh = b.shape
    return b.reshape(sh[:-4] + (sh[-4] * sh[-3], sh[-2] * sh[-1]))


def _assemble(corner, top, left, inner) -> torch.Tensor:
    """The A × A blocks [[corner, top], [left, inner]] from corner (…,), top (…, B−1),
    left (…, A−1) and inner (…, A−1, B−1)."""
    first = torch.cat([corner.unsqueeze(-1), top], -1).unsqueeze(-2)
    return torch.cat([first, torch.cat([left.unsqueeze(-1), inner], -1)], -2)


def _pairs(x1, x2, diag: bool):
    """The pairs of inputs the blocks are taken of: all (…, n, m, d), or with ``diag`` the
    first min(n, m) of each, (…, n, d)."""
    if diag:
        n = min(x1.shape[-2], x2.shape[-2])
        return x1[..., :n, :], x2[..., :n, :]
    return x1.unsqueeze(-2), x2.unsqueeze(-3)


def _out(blocks, diag: bool):
    """The interleaved matrix of the blocks, or with ``diag`` the diagonal of each block,
    (…, n·A)."""
    if diag:
        d = torch.diagonal(blocks, dim1=-2, dim2=-1)
        return d.reshape(d.shape[:-2] + (-1,))
    return _interleave_blocks(blocks)


def _refuse_last_dim_is_batch(name: str, last_dim_is_batch: bool) -> None:
    if last_dim_is_batch:
        raise RuntimeError(f"{name} does not support last_dim_is_batch")


class RBFKernelGrad(RBFKernel):
    """Blocks of the RBF kernel k and its derivatives, u = τ/ℓ² (τ = x − x'): [[k, u_b k],
    [−u_a k, (δ_ab/ℓ_a² − u_a u_b) k]]."""

    def num_outputs_per_input(self, x1, x2) -> int:
        return x1.shape[-1] + 1

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        _refuse_last_dim_is_batch(type(self).__name__, last_dim_is_batch)
        d = x1.shape[-1]
        a, b = _pairs(x1, x2, diag)
        ls2 = hypers["lengthscale"][..., 0, :] ** 2  # batch + (d,)
        ls2 = ls2.reshape(ls2.shape[:-1] + (1,) * (2 if not diag else 1) + (d,))
        tau = a - b
        k = torch.exp(-0.5 * (tau**2 / ls2).sum(-1))
        u = tau / ls2
        eye = torch.eye(d, dtype=k.dtype, device=k.device) / ls2.unsqueeze(-1)
        inner = (eye - u.unsqueeze(-1) * u.unsqueeze(-2)) * k[..., None, None]
        return _out(_assemble(k, u * k.unsqueeze(-1), -u * k.unsqueeze(-1), inner), diag)


class RBFKernelGradGrad(RBFKernel):
    """``RBFKernelGrad``'s blocks extended by the diagonal second derivatives: each input
    gives [f, ∇f, diag ∇²f], 2d + 1 rows."""

    def num_outputs_per_input(self, x1, x2) -> int:
        return 2 * x1.shape[-1] + 1

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        _refuse_last_dim_is_batch(type(self).__name__, last_dim_is_batch)
        d = x1.shape[-1]
        a, b = _pairs(x1, x2, diag)
        ls2 = hypers["lengthscale"][..., 0, :] ** 2
        ls2 = ls2.reshape(ls2.shape[:-1] + (1,) * (2 if not diag else 1) + (d,))
        tau = a - b
        k = torch.exp(-0.5 * (tau**2 / ls2).sum(-1))
        u, il = tau / ls2, 1.0 / ls2  # τ_a/ℓ_a², 1/ℓ_a²
        kk, kkk = k.unsqueeze(-1), k[..., None, None]
        eye_d = torch.eye(d, dtype=k.dtype, device=k.device)
        # value against gradient and gradient against gradient, as RBFKernelGrad
        grad_grad = (eye_d * il.unsqueeze(-1) - u.unsqueeze(-1) * u.unsqueeze(-2)) * kkk
        # ∂²k/∂x'_b² = (u_b² − 1/ℓ_b²) k
        d2k = (u**2 - il) * kk
        # ∂³k/∂x_a ∂x'_b² = 2δ_ab u_b k/ℓ_b² − u_a (u_b² − 1/ℓ_b²) k
        third = -u.unsqueeze(-1) * d2k.unsqueeze(-2) + 2.0 * eye_d * (u * il).unsqueeze(-2) * kkk
        # ∂⁴k/∂x_a² ∂x'_b² = [(u_a² − 1/ℓ_a²)(u_b² − 1/ℓ_b²) + δ_ab (2/ℓ_b⁴ − 4 u_b²/ℓ_b²)] k
        uu = u**2
        fourth = ((uu - il).unsqueeze(-1) * (uu - il).unsqueeze(-2)
                  + eye_d * (2.0 * (il * il) - 4.0 * (uu * il)).unsqueeze(-2)) * kkk
        top = torch.cat([u * kk, d2k], -1)
        left = torch.cat([-u * kk, d2k], -1)
        inner = torch.cat([torch.cat([grad_grad, third], -1), torch.cat([-third.transpose(-1, -2), fourth], -1)], -2)
        return _out(_assemble(k, top, left, inner), diag)


class Matern52KernelGrad(MaternKernel):
    """Blocks of the Matérn-5/2 kernel and its derivatives in closed form, r = ‖τ/ℓ‖ floored
    at √1e-30: ∂k/∂τ_a = −(5/3)(1 + √5 r) e^{−√5 r} τ_a/ℓ_a², ∂²k/∂x_a∂x'_b = (5/3)[(1 + √5 r)
    δ_ab/ℓ_b² − 5 τ_a τ_b/(ℓ_a² ℓ_b²)] e^{−√5 r}."""

    def __init__(self, **kwargs):
        kwargs.pop("nu", None)
        super().__init__(nu=2.5, **kwargs)

    def num_outputs_per_input(self, x1, x2) -> int:
        return x1.shape[-1] + 1

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        _refuse_last_dim_is_batch(type(self).__name__, last_dim_is_batch)
        d = x1.shape[-1]
        a, b = _pairs(x1, x2, diag)
        ls2 = hypers["lengthscale"][..., 0, :] ** 2
        ls2 = ls2.reshape(ls2.shape[:-1] + (1,) * (2 if not diag else 1) + (d,))
        tau = a - b
        r2 = (tau**2 / ls2).sum(-1)
        r = torch.sqrt(torch.clamp_min(r2, 1e-30))
        s5 = math.sqrt(5.0)
        e = torch.exp(-s5 * r)
        k = (1.0 + s5 * r + 5.0 / 3.0 * r2) * e
        g = (5.0 / 3.0) * (1.0 + s5 * r) * e
        u = tau / ls2
        eye = torch.eye(d, dtype=k.dtype, device=k.device) / ls2.unsqueeze(-1)
        hess = (5.0 / 3.0) * ((1.0 + s5 * r)[..., None, None] * eye - 5.0 * (u.unsqueeze(-1) * u.unsqueeze(-2))) \
            * e[..., None, None]
        return _out(_assemble(k, g.unsqueeze(-1) * u, -g.unsqueeze(-1) * u, hess), diag)


class PolynomialKernelGrad(PolynomialKernel):
    """Blocks of k = (x·x' + c)^p and its derivatives: ∂k/∂x'_b = p s^{p−1} x_b,
    ∂k/∂x_a = p s^{p−1} x'_a, ∂²k/∂x_a∂x'_b = p(p−1) s^{p−2} x'_a x_b + p s^{p−1} δ_ab for
    s = x·x' + c."""

    def num_outputs_per_input(self, x1, x2) -> int:
        return x1.shape[-1] + 1

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        _refuse_last_dim_is_batch(type(self).__name__, last_dim_is_batch)
        d, p = x1.shape[-1], self.power
        c = hypers["offset"]
        if diag:
            n = min(x1.shape[-2], x2.shape[-2])
            a, b = x1[..., :n, :], x2[..., :n, :]
            base = (a * b).sum(-1) + c
        else:
            a, b = x1.unsqueeze(-2), x2.unsqueeze(-3)
            base = x1 @ x2.mT + c.unsqueeze(-1)
        k = torch.pow(base, p)
        bp1 = torch.pow(base, p - 1)
        bp2 = torch.pow(base, p - 2) if p >= 2 else torch.zeros_like(base)
        eye = torch.eye(d, dtype=k.dtype, device=k.device)
        inner = p * (p - 1) * bp2[..., None, None] * (b.unsqueeze(-1) * a.unsqueeze(-2)) + p * bp1[..., None, None] * eye
        return _out(_assemble(k, p * bp1.unsqueeze(-1) * a, p * bp1.unsqueeze(-1) * b, inner), diag)
