"""Preconditioned conjugate gradients for all columns of the right-hand side at once, with
the Lanczos tridiagonals of stochastic Lanczos quadrature (mBCG).

Counterpart of ``gpytorch_tpu/solvers/cg.py::linear_cg`` and ``tridiag_from_coeffs``,
without the sharded reductions and the unrolling.  It keeps the JAX package's safeguards:
tolerance on the normalised columns, relative positivity guards on the curvature,
best-iterate tracking and the stall window; and its training options: the minimum
iteration count ``n_tridiag_iter`` with the CG coefficients of those iterations stored, a
warm start ``x0``, convergence gated on the first ``conv_cols`` columns, and the lagged
warm-rhs initialisation.  The loop runs in Python and synchronises with the host once per
iteration, to decide whether to stop.  A batched right-hand side (*batch, n, t) solves
every element's columns in the same loop; the stop waits for all of them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import settings

# a right-hand side column, or a curvature rz, below this counts as zero
_EPS = 1e-10


class CGResult(NamedTuple):
    solution: torch.Tensor                 # (*batch, n, t)
    num_iters: int
    residual_norm: torch.Tensor            # (*batch, t) best relative residual of each column
    alphas: Optional[torch.Tensor] = None  # (n_tridiag_iter, *batch, t) where n_tridiag_iter > 0
    betas: Optional[torch.Tensor] = None   # (n_tridiag_iter, *batch, t) where n_tridiag_iter > 0


def _col_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min((x * x).sum(-2), 0.0))


def linear_cg(
    matmul_fn: Callable[[torch.Tensor], torch.Tensor],
    rhs: torch.Tensor,
    precond_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    max_iter: Optional[int] = None,
    tolerance: Optional[float] = None,
    n_tridiag_iter: int = 0,
    x0: Optional[torch.Tensor] = None,
    conv_cols: Optional[int] = None,
    lagged_rhs_init: bool = False,
) -> CGResult:
    """Solve A x = rhs for every column of rhs (*batch, n, t).

    Each column is normalised to unit norm, so ``tolerance`` is a relative residual.  CG
    runs at least ``n_tridiag_iter`` iterations (storing α and β of those, for
    ``tridiag_from_coeffs``), then stops when every gating column has converged, after
    ``max_iter`` iterations, or when no gating column has improved its best residual for
    ``settings.cg_stall_window`` iterations; in a batch, over the columns of every
    element.  The gating columns are all of them, or the
    first ``conv_cols``; those return their best iterate, the others their last (its
    A-norm error is the one that shrinks monotonically).

    ``x0`` warm-starts the solve (one extra product for its residual).  With
    ``lagged_rhs_init`` and ``conv_cols``, the gating columns instead start at x = 0,
    r = b, p = x₀ with a forced α = 1, β = 0 in the first iteration, which performs the
    warm start inside that iteration's product; the other columns must then start at
    zero.  Tridiagonals are valid only for columns that start at zero."""
    if max_iter is None:
        max_iter = settings.max_cg_iterations.value()
    if tolerance is None:
        tolerance = settings.cg_tolerance.value()
    n = rhs.shape[-2]
    max_iter = int(min(max_iter, 2 * n + 10))
    n_tridiag_iter = int(min(n_tridiag_iter, max_iter))
    stall_window = int(settings.cg_stall_window.value())
    if precond_fn is None:
        precond_fn = lambda v: v  # noqa: E731

    rhs_norm = _col_norm(rhs).unsqueeze(-2)
    rhs_is_zero = rhs_norm < _EPS
    rhs_norm = torch.where(rhs_is_zero, torch.ones_like(rhs_norm), rhs_norm)
    b = rhs / rhs_norm
    t = b.shape[-1]
    gated = torch.arange(t, device=b.device) < (t if conv_cols is None else conv_cols)

    lagged = bool(lagged_rhs_init) and x0 is not None and conv_cols is not None
    if x0 is not None and not lagged:
        if n_tridiag_iter > 0 and conv_cols is None:
            raise ValueError("linear_cg: a warm start x0 gives no valid tridiagonals unless conv_cols is set")
        x = x0 / rhs_norm
        r = b - matmul_fn(x)
    else:
        x = torch.zeros_like(b)
        r = b
    z = precond_fn(r)
    p = torch.where(gated, x0 / rhs_norm, z) if lagged else z
    rz = (r * z).sum(-2)
    conv = torch.zeros_like(rz, dtype=torch.bool)
    # best-iterate tracking starts from the initial iterate: a gating column never returns
    # anything worse than where it started
    best_resid = _col_norm(r)
    x_best = x
    floor_rel = 10.0 * torch.finfo(rhs.dtype).eps
    alphas, betas = [], []

    k, since, all_conv = 0, 0, False
    while k < n_tridiag_iter or (k < max_iter and not all_conv and since < stall_window):
        Ap = matmul_fn(p)
        pAp = (p * Ap).sum(-2)
        # Relative positivity guards: in finite precision pᵀAp and rᵀP⁻¹r can reach noise
        # level; such a column freezes for this step and restarts from steepest descent.
        krylov_dead = (pAp <= floor_rel * _col_norm(p) * _col_norm(Ap)) | (rz <= 0.0)
        alpha_raw = rz / torch.where(krylov_dead, torch.ones_like(pAp), pAp)
        alpha = torch.where(conv | krylov_dead, torch.zeros_like(alpha_raw), alpha_raw)
        forced = lagged and k == 0
        if forced:
            # the gating columns' warm-start step x ← x₀ (p was seeded with x₀), r ← b − A x₀
            alpha = torch.where(gated, torch.ones_like(alpha), alpha)

        x = x + alpha.unsqueeze(-2) * p
        r = r - alpha.unsqueeze(-2) * Ap
        resid = _col_norm(r)
        conv_new = conv | (resid < tolerance)

        improved = resid < best_resid
        x_best = torch.where(improved.unsqueeze(-2), x, x_best)
        best_resid = torch.minimum(best_resid, resid)

        z = precond_fn(r)
        rz_new = (r * z).sum(-2)
        beta_raw = rz_new / torch.where(rz.abs() < _EPS, torch.ones_like(rz), rz)
        beta = torch.where(conv_new | krylov_dead, torch.zeros_like(beta_raw), beta_raw)
        if forced:
            beta = torch.where(gated, torch.zeros_like(beta), beta)
        p = z + beta.unsqueeze(-2) * p
        if k < n_tridiag_iter:
            # dead or converged columns store α = 1, β = 0: a unit Ritz value, log 1 = 0
            alphas.append(torch.where(conv | krylov_dead, torch.ones_like(alpha_raw), alpha_raw))
            betas.append(beta)
        rz, conv = rz_new, conv_new
        k += 1

        all_conv, any_improved = torch.stack([(conv | ~gated).all(), (improved & gated).any()]).tolist()
        since = 0 if any_improved else since + 1

    x_out = torch.where(gated, x_best, x) if conv_cols is not None else x_best
    solution = torch.where(rhs_is_zero, torch.zeros_like(x_out), x_out * rhs_norm)
    if n_tridiag_iter > 0:
        return CGResult(solution, k, best_resid, torch.stack(alphas), torch.stack(betas))
    return CGResult(solution, k, best_resid)


def tridiag_from_coeffs(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Symmetric Lanczos tridiagonals T from CG coefficients: alphas, betas (m, *batch, t)
    → T (*batch, t, m, m) with T[0,0] = 1/α₀, T[k,k] = 1/α_k + β_{k−1}/α_{k−1} and
    T[k−1,k] = T[k,k−1] = √β_{k−1}/α_{k−1}."""
    inv_a = 1.0 / alphas.movedim(0, -1)  # (*batch, t, m)
    bc = betas.movedim(0, -1)
    diag = inv_a.clone()
    diag[..., 1:] += bc[..., :-1] * inv_a[..., :-1]
    off = torch.sqrt(torch.clamp_min(bc[..., :-1], 0.0)) * inv_a[..., :-1]
    return torch.diag_embed(diag) + torch.diag_embed(off, offset=1) + torch.diag_embed(off, offset=-1)


def refined_solve(solve: Callable[[torch.Tensor], CGResult], matmul_fn: Callable[[torch.Tensor], torch.Tensor],
                  rhs: torch.Tensor) -> CGResult:
    """``solve(rhs)``, then ``settings.solve_iterative_refinements`` passes of iterative
    refinement, x ← x + solve(rhs − A x), each against the residual of the solution so far
    (one product and one more solve a pass; ``gpytorch_tpu/solvers/cg.py:305-316``).  The
    result counts every pass's iterations, and its residual is the last pass's relative
    residual scaled to rhs: |b − A x| / |b| by CG's own recursion."""
    result = solve(rhs)
    x, iters, resid = result.solution, result.num_iters, result.residual_norm
    rhs_norm = torch.clamp_min(_col_norm(rhs), _EPS)
    for _ in range(int(settings.solve_iterative_refinements.value())):
        r = rhs - matmul_fn(x)
        corr = solve(r)
        x, iters = x + corr.solution, iters + corr.num_iters
        resid = corr.residual_norm * _col_norm(r) / rhs_norm
    return CGResult(x, iters, resid)


def linear_solve_cg(linop, rhs: torch.Tensor) -> CGResult:
    """CG solve of ``linop`` x = rhs, preconditioned by ``linop._preconditioner()``, at
    ``settings.cg_tolerance``, refined ``settings.solve_iterative_refinements`` times."""
    precond = linop._preconditioner()[0]
    return refined_solve(lambda b: linear_cg(linop._matmul, b, precond_fn=precond), linop._matmul, rhs)
