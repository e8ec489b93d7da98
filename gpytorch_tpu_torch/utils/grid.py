"""Grid utilities for KISS-GP.

Counterpart of ``gpytorch_tpu/utils/grid.py``: ``ScaleToBounds``, ``choose_grid_size``,
``create_grid`` (per-dimension 1D grids, extended one step past each bound), and
``create_data_from_grid`` (their Cartesian product, the first dimension varying fastest).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.module import Module


class ScaleToBounds(Module):
    """Scales inputs into (lower, upper)·0.95; the bounds are fitted on each training-mode
    call and reused at eval time."""

    def __init__(self, lower_bound: float, upper_bound: float):
        super().__init__()
        self.lower_bound = float(lower_bound)
        self.upper_bound = float(upper_bound)
        self.register_buffer("min_val", torch.tensor(self.lower_bound))
        self.register_buffer("max_val", torch.tensor(self.upper_bound))

    def forward(self, x):
        if self.training:
            self.min_val = x.min().detach()
            self.max_val = x.max().detach()
        diff = self.max_val - self.min_val
        return (x - self.min_val) * (0.95 * (self.upper_bound - self.lower_bound) / diff) + 0.95 * self.lower_bound


def choose_grid_size(train_inputs: torch.Tensor, ratio: float = 1.0, kronecker_structure: bool = True) -> int:
    """Grid points a dimension: ratio · N^(1/d) with Kronecker structure, else ratio · N."""
    num_data = train_inputs.shape[0] if train_inputs.ndim == 1 else train_inputs.shape[-2]
    num_dim = 1 if train_inputs.ndim == 1 else train_inputs.shape[-1]
    if kronecker_structure:
        return int(ratio * math.pow(num_data, 1.0 / num_dim))
    return int(ratio * num_data)


def convert_legacy_grid(grid: torch.Tensor) -> List[torch.Tensor]:
    return [grid[:, i] for i in range(grid.shape[-1])]


def create_data_from_grid(grid) -> torch.Tensor:
    """(∏ m_d, d): the Cartesian product of the per-dimension grids, first dimension fastest."""
    if torch.is_tensor(grid):
        grid = convert_legacy_grid(grid)
    projections = torch.meshgrid(*grid, indexing="ij")
    # reversing the axes makes the first dimension the fastest in the flattened order
    stacked = torch.stack([p.permute(*reversed(range(len(grid)))) for p in projections], -1)
    return stacked.reshape(-1, len(grid))


def create_grid(grid_sizes: Sequence[int], grid_bounds: Sequence[Tuple[float, float]], extend: bool = True,
                dtype: torch.dtype = torch.float32, device=None) -> List[torch.Tensor]:
    """Per-dimension grids of ``grid_sizes`` points over ``grid_bounds``, with ``extend``
    one spacing (of the bounds over size − 2) past each bound.  The points come from
    ``numpy.linspace`` in float64, cast to ``dtype``, as the JAX package makes them."""
    grid = []
    for size, (lo, hi) in zip(grid_sizes, grid_bounds):
        step = float(hi - lo) / (size - 2)
        a, b = (lo - step, hi + step) if extend else (lo, hi)
        grid.append(torch.as_tensor(np.linspace(a, b, size)).to(dtype=dtype, device=device))
    return grid
