"""Contour-integral quadrature (CIQ): K^{±1/2}·v by multi-shift CG.

Counterpart of ``gpytorch_tpu/solvers/contour.py`` (Pleiss et al. 2020, arXiv 2006.11267;
the quadrature of Hale, Higham & Trefethen 2008):

    K^{-1/2} b ≈ Σ_j w_j (K + t_j I)⁻¹ b,

with shifts t_j and weights w_j from Jacobi elliptic functions on a spectrum [λ_min, λ_max]
that ten Lanczos steps from the ones vector estimate (without gradient).  All q shifted
systems share one Krylov space, so each iteration of the multi-shift CG (Jegerlehner's
recurrences) is one product with K: for a lazy kernel operator one launch of the K·V kernel
at the right-hand side's width.

The backward (``_CIQQuad``) does not differentiate through the CG loop: with
d[(K + t)⁻¹] = −(K + t)⁻¹ dK (K + t)⁻¹ it runs one more multi-shift CG on the cotangent,
u_j = (K + t_j I)⁻¹ ḡ, returns Σ_j w_j u_j to the right-hand side and takes the operator's
cotangents from −Σ_j w_j u_jᵀ K s_j (s_j the forward's solves) through the operator
product's own backward, at the q·t columns of all the shifts at once.  The product's value
is never read (``_matmul_grad_only``): for a symmetric lazy kernel operator that is one
launch of the fused symmetric backward kernel and no forward product, where the JAX
package's VJP also forms the product.

The loop exits on the largest residual over all columns of the unshifted system (a bound on
every shifted residual) at ``settings.minres_tolerance`` relative to the right-hand side,
or at ``settings.max_minres_iterations``: one host read an iteration, as the port's CG has.
The backward keeps the forward's tolerance and cap (it runs after the caller's settings have
gone out of scope).  ``last_iterations`` keeps the counts of the last forward and backward.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import settings
from .lanczos import lanczos_tridiag

_AGM_ITERS = 30
_EPS = 1e-30

# iterations of the last multi-shift CG of a forward and of a backward
last_iterations = {"forward": None, "backward": None}


def _ellipk_agm(m: torch.Tensor) -> torch.Tensor:
    """The complete elliptic integral K(m) by the arithmetic-geometric mean."""
    a, b = torch.ones_like(m), torch.sqrt(torch.clamp_min(1.0 - m, 1e-300))
    for _ in range(_AGM_ITERS):
        a, b = 0.5 * (a + b), torch.sqrt(a * b)
    return math.pi / (2.0 * a)


def _ellipj_real(u: torch.Tensor, m: torch.Tensor):
    """sn, cn, dn(u | m) for real u by the descending Landen transformation (Abramowitz &
    Stegun 16.4), a fixed number of steps."""
    a = torch.ones_like(u)
    b = torch.sqrt(torch.clamp_min(1.0 - m, 1e-300)) * torch.ones_like(u)
    a_list, c_list = [], []
    for _ in range(_AGM_ITERS):
        a, b, c = 0.5 * (a + b), torch.sqrt(torch.clamp_min(a * b, 1e-300)), 0.5 * (a - b)
        a_list.append(a)
        c_list.append(c)
    phi = (2.0 ** _AGM_ITERS) * a * u
    for n in range(_AGM_ITERS - 1, -1, -1):
        ratio = torch.clamp(c_list[n] / torch.clamp_min(a_list[n], 1e-300), -1.0, 1.0)
        phi = 0.5 * (phi + torch.arcsin(ratio * torch.sin(phi)))
    sn, cn = torch.sin(phi), torch.cos(phi)
    return sn, cn, torch.sqrt(torch.clamp_min(1.0 - m * sn * sn, 1e-300))


def _ellipj_im(u: torch.Tensor, m: torch.Tensor):
    """The real factors (s/c, 1/c, d/c) of sn, cn, dn at the imaginary argument iu, by
    Jacobi's imaginary transformation: s, c, d = sn, cn, dn(u | 1 − m)."""
    s, c, d = _ellipj_real(u, 1.0 - m)
    return s / c, 1.0 / c, d / c


def _elliptic_nodes(min_eig, max_eig, num_quad: int):
    """(shifts, weights) of the quadrature of f(K) = K^{-1/2} on [min_eig, max_eig], in the
    dtype of ``min_eig`` (``gpytorch_tpu/solvers/contour.py:71-93``)."""
    min_eig = torch.as_tensor(min_eig)
    max_eig = torch.as_tensor(max_eig, dtype=min_eig.dtype, device=min_eig.device)
    k2 = torch.clamp(min_eig / max_eig, 1e-10, 1.0 - 1e-10)
    Kp = _ellipk_agm(1.0 - k2)  # K'(k) = K(1 − k²)
    u = (torch.arange(1, num_quad + 1, dtype=min_eig.dtype, device=min_eig.device) - 0.5) * Kp / num_quad
    sn_i, cn_i, dn_i = _ellipj_im(u, k2)
    shifts = min_eig * sn_i * sn_i
    weights = (2.0 * Kp * torch.sqrt(min_eig)) / (math.pi * num_quad) * (cn_i * dn_i)
    return shifts, weights


def _estimate_spectrum(linop) -> Tuple[torch.Tensor, torch.Tensor]:
    """(0.8 λ_min, 1.2 λ_max) from the Ritz values of min(10, n) Lanczos steps from the ones
    vector, without gradient (``gpytorch_tpu/solvers/contour.py:96-106``)."""
    n = linop.shape[-1]
    with torch.no_grad():
        init = torch.ones(linop.batch_shape + (n,), dtype=linop.dtype, device=linop.device)
        _, T = lanczos_tridiag(linop._matmul, init, min(10, n))
        lam = torch.linalg.eigvalsh(T)
    return lam[..., 0].clamp_min(1e-7).min() * 0.8, lam[..., -1].max() * 1.2


def _where_safe(small: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return torch.where(small, torch.ones_like(value), value)


def shifted_cg(matmul_fn, rhs: torch.Tensor, shifts: torch.Tensor, max_iter: int,
               tol: Optional[float] = None) -> Tuple[torch.Tensor, int]:
    """Solves (A + t_j I) x_j = rhs for every shift with one product by A an iteration
    (``gpytorch_tpu/solvers/contour.py:109-179``).  rhs (..., n, t), shifts (q,) ≥ 0;
    returns (x (q, ..., n, t), iterations).  Stops when the unshifted system's largest
    column residual² falls to tol²·max |rhs column|² (tol: ``settings.minres_tolerance``),
    or after ``max_iter`` iterations."""
    if tol is None:
        tol = float(settings.minres_tolerance.value())
    q, dt = shifts.shape[0], rhs.dtype
    x = torch.zeros((q,) + rhs.shape, dtype=dt, device=rhs.device)
    r, p = rhs, rhs
    p_s = rhs.expand((q,) + rhs.shape).clone()
    rz = (r * r).sum(-2)  # (..., t)
    zeta_prev = torch.ones((q,) + rz.shape, dtype=dt, device=rhs.device)
    zeta_cur = zeta_prev.clone()
    alpha_prev, beta_prev = torch.ones_like(rz), torch.zeros_like(rz)
    sh = shifts.to(dt).reshape((q,) + (1,) * rz.ndim)
    limit = (tol * tol) * (rhs * rhs).sum(-2).max().clamp_min(_EPS)
    k = 0
    while k < max_iter and bool(rz.max() > limit):
        Ap = matmul_fn(p)
        pAp = (p * Ap).sum(-2)
        dead = rz < _EPS
        alpha = torch.where(dead, torch.zeros_like(rz), rz / _where_safe(pAp.abs() < _EPS, pAp))
        # ζ_{k+1} of each shift (Jegerlehner, eq. 2.44)
        denom = alpha * beta_prev * (zeta_prev - zeta_cur) + zeta_prev * alpha_prev * (1.0 + sh * alpha)
        small = denom.abs() < _EPS
        zeta_next = torch.where(small, zeta_cur, zeta_cur * zeta_prev * alpha_prev / _where_safe(small, denom))
        ratio = zeta_next / _where_safe(zeta_cur.abs() < _EPS, zeta_cur)
        x.addcmul_((alpha * ratio).unsqueeze(-2), p_s)
        r_new = r - alpha.unsqueeze(-2) * Ap
        rz_new = (r_new * r_new).sum(-2)
        beta = torch.where(dead, torch.zeros_like(rz), rz_new / _where_safe(rz < _EPS, rz))
        p = r_new + beta.unsqueeze(-2) * p
        p_s.mul_((beta * ratio * ratio).unsqueeze(-2)).addcmul_(zeta_next.unsqueeze(-2), r_new)
        r, rz, zeta_prev, zeta_cur, alpha_prev, beta_prev = r_new, rz_new, zeta_cur, zeta_next, alpha, beta
        k += 1
    return x, k


def _flat_columns(a: torch.Tensor) -> torch.Tensor:
    """(q, ..., n, t) → (..., n, t·q), the shifts last (the JAX package's moveaxis)."""
    return a.movedim(0, -1).reshape(a.shape[1:-1] + (-1,))


class _CIQQuad(torch.autograd.Function):
    """Σ_j w_j (K + t_j I)⁻¹ rhs, differentiable in rhs and in the operator's tensors
    (``_flatten``) by the quadrature-structured backward of the module docstring
    (``gpytorch_tpu/solvers/contour.py:182-229``).  The shifts and weights are constants."""

    @staticmethod
    def forward(ctx, rebuild, rhs, shifts, weights, max_iter, *tensors):
        op = rebuild(tensors)
        tol = float(settings.minres_tolerance.value())  # the backward's too: it runs outside the caller's settings
        solves, last_iterations["forward"] = shifted_cg(op._matmul, rhs, shifts, max_iter, tol)
        w = weights.reshape((-1,) + (1,) * rhs.ndim)
        ctx.rebuild, ctx.max_iter, ctx.tol = rebuild, max_iter, tol
        ctx.save_for_backward(solves, shifts, weights, *tensors)
        return (w * solves).sum(0)

    @staticmethod
    def backward(ctx, g):
        solves, shifts, weights, *tensors = ctx.saved_tensors
        op = ctx.rebuild(tensors)
        u, last_iterations["backward"] = shifted_cg(op._matmul, g.contiguous(), shifts, ctx.max_iter, ctx.tol)
        w = weights.reshape((-1,) + (1,) * g.ndim)
        needs = ctx.needs_input_grad[5:]
        grads = iter(())
        if any(needs):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(need) for t, need in zip(tensors, needs)]
                # −Σ_j w_j u_jᵀ K s_j at the q·t columns of every shift at once
                quad = -(_flat_columns(u * w) * ctx.rebuild(leaves)._matmul_grad_only(_flat_columns(solves))).sum()
                grads = iter(torch.autograd.grad(quad, [leaf for leaf in leaves if leaf.requires_grad],
                                                 allow_unused=True))
        rhs_bar = (w * u).sum(0) if ctx.needs_input_grad[1] else None
        return (None, rhs_bar, None, None, None, *[next(grads) if need else None for need in needs])


def contour_integral_quad(linop, rhs: torch.Tensor, inverse: bool = True, num_quad: Optional[int] = None):
    """K^{-1/2} rhs (``inverse``) or K^{1/2} rhs = K·K^{-1/2} rhs, for a symmetric positive
    definite operator K and rhs (..., n, t)."""
    if num_quad is None:
        num_quad = settings.num_contour_quadrature.value()
    op = linop.evaluate_kernel()
    min_eig, max_eig = _estimate_spectrum(op)
    shifts, weights = _elliptic_nodes(min_eig, max_eig, int(num_quad))
    try:
        tensors, rebuild = op._flatten()
    except NotImplementedError:  # an operator without _flatten: no gradient reaches it
        tensors, rebuild = (), lambda ts: op
    inv_sqrt = _CIQQuad.apply(rebuild, rhs, shifts.to(rhs.dtype), weights.to(rhs.dtype),
                              int(settings.max_minres_iterations.value()), *tensors)
    return inv_sqrt if inverse else op._matmul(inv_sqrt)


def sqrt_inv_matmul(linop, rhs: torch.Tensor, lhs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K^{-1/2} rhs, or lhs K^{-1/2} rhs where ``lhs`` is given; rhs (n,) or (..., n, t)."""
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs.unsqueeze(-1)
    res = contour_integral_quad(linop, rhs, inverse=True)
    if lhs is not None:
        res = lhs @ res
    return res.squeeze(-1) if squeeze else res
