"""Pivoted (partial) Cholesky — the low-rank CG preconditioner — and its Nyström form.

Counterpart of ``gpytorch_tpu/solvers/pivoted_cholesky.py``.  Reads only the operator's
diagonal and ``rank`` of its rows (``_get_rows``), never the whole matrix.  The loop runs
on the device without host synchronisation: pivots stay tensors.  A batched operator is
factored per batch element in the same loop.  Columns are kept out of
place, so autograd can differentiate the loop; ``nystrom_factor_from_pivots`` is the
cheaper differentiable form on a fixed pivot set.
"""

from __future__ import annotations

import torch

# floor of the pivot under the square root and of the stopping tolerance
_JITTER = 1e-8


def pivoted_cholesky(linop, rank: int, rel_tol: float = 0.0, return_pivots: bool = False, pivots=None):
    """L of shape batch + (n, rank) with L Lᵀ ≈ linop (greedy pivoting on the residual
    diagonal), and with ``return_pivots`` the pivot of each column, of shape batch + (rank,).
    A batched operator is factored per element, each with its own pivots, as the JAX
    package's scan is (``gpytorch_tpu/solvers/pivoted_cholesky.py:48, 90``).  ``pivots``
    (batch + (rank,) indices) replaces the greedy choice by a given order: where the residual
    diagonal ties to round-off, as on a periodic kernel of low numerical rank, two devices
    or dtypes pick different pivots, and a pinned order makes their factors comparable.

    Columns past the point where the residual diagonal reaches the round-off floor of the
    original diagonal — or, with ``rel_tol`` > 0, where the residual trace falls below
    ``rel_tol`` of the original — are exactly zero."""
    diag = linop._diagonal()
    batch, n = tuple(diag.shape[:-1]), diag.shape[-1]
    rank = int(min(rank, n))
    eps = torch.finfo(diag.dtype).eps
    stop_tol = torch.clamp_min(10.0 * eps * diag.amax(-1), _JITTER)
    orig_trace = torch.clamp_min(diag.sum(-1), 1e-30)
    positions = torch.arange(n, device=diag.device)

    d = diag
    L = torch.zeros(batch + (n, rank), dtype=diag.dtype, device=diag.device)
    columns = torch.arange(rank, device=diag.device)
    given = None if pivots is None else torch.as_tensor(pivots, device=diag.device)
    pivots = torch.empty(batch + (rank,), dtype=torch.long, device=diag.device)
    for m in range(rank):
        pivot = torch.argmax(d, dim=-1) if given is None else given[..., m].expand(batch)
        pivot_val = torch.take_along_dim(d, pivot.unsqueeze(-1), dim=-1).squeeze(-1)
        row = linop._get_rows(pivot.reshape(batch + (1,)))[..., 0, :]
        L_pivot = torch.take_along_dim(L, pivot.reshape(batch + (1, 1)), dim=-2)  # (*batch, 1, rank)
        correction = (L @ L_pivot.mT).squeeze(-1)
        col = (row - correction) / torch.sqrt(torch.clamp_min(pivot_val, _JITTER)).unsqueeze(-1)
        live = pivot_val > stop_tol
        if rel_tol > 0.0:
            live = live & (d.sum(-1) > rel_tol * orig_trace)
        col = torch.where(live.unsqueeze(-1) & torch.isfinite(col), col, torch.zeros_like(col))
        d = torch.where(positions == pivot.unsqueeze(-1), torch.zeros_like(d), torch.clamp_min(d - col * col, 0.0))
        # out of place, so that autograd can differentiate the loop
        L = torch.where(columns == m, col.unsqueeze(-1), L)
        pivots[..., m] = pivot
    return (L, pivots) if return_pivots else L


def nystrom_factor_from_pivots(linop, pivots: torch.Tensor, jitter_rel: float = 1e-6) -> torch.Tensor:
    """Differentiable rank-k root on a fixed pivot set: L = K[:, piv] R⁻ᵀ with
    R = chol(K[piv, piv]), so L Lᵀ = K[:, piv] K[piv, piv]⁻¹ K[piv, :] — in exact
    arithmetic the factor pivoted Cholesky builds on those pivots.  One k×k Cholesky and
    one (k, n) triangular solve, with only the k kernel rows feeding the gradient."""
    from .cholesky import psd_safe_cholesky

    k = pivots.shape[-1]
    rows = linop._get_rows(pivots)  # (*batch, k, n)
    C = torch.take_along_dim(rows, pivots.unsqueeze(-2).expand(rows.shape[:-1] + (k,)), dim=-1)
    C = 0.5 * (C + C.mT)
    # relative jitter: C carries the kernel's scale; it guards truncated or repeated pivots
    tr = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1) / k
    eye = torch.eye(k, dtype=C.dtype, device=C.device)
    R = psd_safe_cholesky(C + (jitter_rel * tr)[..., None, None] * eye)
    Y = torch.linalg.solve_triangular(R, rows, upper=False)  # (*batch, k, n) = R⁻¹ K[piv, :]
    return Y.mT
