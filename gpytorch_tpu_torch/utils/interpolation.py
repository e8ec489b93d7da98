"""Cubic-convolution interpolation weights for KISS-GP (SKI).

Counterpart of ``gpytorch_tpu/utils/interpolation.py``: each target point gets 4 weights
a dimension from Keys' cubic convolution kernel (a = −0.5), on the window of 4 grid points
around it, combined across dimensions by outer product into 4^d weights, with the combined
grid index running fastest in the first dimension (``utils.grid.create_data_from_grid``).
Targets outside the grid are clamped onto it, and each dimension's 4 weights are
normalised to sum to one, which is exact inside the grid and keeps clamped edges exact.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.interp import left_interp, left_t_interp  # noqa: F401  (the JAX module's re-exports)


def _cubic_interpolation_kernel(scaled_grid_dist: torch.Tensor) -> torch.Tensor:
    """Keys (1981) cubic convolution kernel with a = −0.5."""
    U = scaled_grid_dist.abs()
    inner = (1.5 * U**3 - 2.5 * U**2 + 1) * (U < 1).to(U.dtype)
    outer = (-0.5 * U**3 + 2.5 * U**2 - 4 * U + 2) * ((U >= 1) & (U <= 2)).to(U.dtype)
    return torch.zeros_like(U) + inner + outer


class Interpolation:
    def interpolate(self, x_grid: Sequence[torch.Tensor], x_target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(indices, values), both (n, 4^d), with W[i, indices[i, q]] = values[i, q]."""
        if x_target.ndim == 1:
            x_target = x_target.unsqueeze(-1)
        dtype = x_target.dtype
        indices = values = None
        stride = 1
        for d in range(x_target.shape[-1]):
            grid = x_grid[d]
            m = grid.shape[0]
            if m < 4:
                raise RuntimeError("SKI interpolation requires at least 4 grid points per dim")
            h = grid[1] - grid[0]
            lo, hi = grid[0].to(dtype), grid[-1].to(dtype)
            x = torch.minimum(torch.maximum(x_target[..., d], lo), hi)
            u = (x - grid[0]) / h  # fractional grid coordinate
            left = (torch.floor(u).long() - 1).clamp(0, m - 4)  # window start i − 1
            idx = left.unsqueeze(-1) + torch.arange(4, device=x.device)
            vals = _cubic_interpolation_kernel(u.unsqueeze(-1) - idx.to(u.dtype))
            vals = vals / vals.sum(-1, keepdim=True)
            idx = idx * stride
            if indices is None:
                indices, values = idx, vals
            else:
                indices = (indices.unsqueeze(-1) + idx.unsqueeze(-2)).flatten(-2)
                values = (values.unsqueeze(-1) * vals.unsqueeze(-2)).flatten(-2)
            stride *= m
        return indices, values
