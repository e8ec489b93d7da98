"""GridInterpolationKernel — KISS-GP (SKI): K ≈ W K_UU Wᵀ.

Counterpart of ``gpytorch_tpu/kernels/grid_interpolation_kernel.py``: W is the sparse cubic
interpolation matrix (4^d nonzeros a row, ``utils/interpolation.py``) and K_UU a
``GridKernel``'s Toeplitz (⊗ Toeplitz) covariance on the grid, so the kernel matrix is an
``InterpolatedLinearOperator`` and its products are a scatter-add, FFTs and a gather.

Without ``grid_bounds`` the grid is dynamic: it is refitted to the inputs at the first
evaluation, and again whenever inputs leave it (by more than 2.01 spacings from its
edges), as in the JAX package.  Its state lives in buffers — the grids, ``grid_bounds``
(d, 2) and ``has_initialized_grid`` — which ``load_jax_params`` carries over.  A refit reads
the inputs' extent on the host.

With ``last_dim_is_batch`` every input dimension is interpolated alone on a 1D grid, its own
or (a kernel of one grid dimension, as SKIP builds it) the one grid, against the grid
covariances stacked a dimension: an ``InterpolatedLinearOperator`` of batch (…, d)
(``gpytorch_tpu/kernels/grid_interpolation_kernel.py:67-89``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..linop import InterpolatedLinearOperator
from ..utils.grid import create_grid
from ..utils.interpolation import Interpolation
from .grid_kernel import GridKernel
from .kernel import Kernel


class GridInterpolationKernel(GridKernel):
    def __init__(self, base_kernel: Kernel, grid_size, num_dims: Optional[int] = None,
                 grid_bounds: Optional[Sequence[Tuple[float, float]]] = None):
        if grid_bounds is None:
            if num_dims is None:
                raise RuntimeError("num_dims must be supplied if grid_bounds is omitted")
            bounds = [(-10.0, 10.0)] * num_dims
        else:
            if num_dims is None:
                num_dims = len(grid_bounds)
            elif num_dims != len(grid_bounds):
                raise RuntimeError("num_dims disagrees with grid_bounds")
            bounds = [tuple(b) for b in grid_bounds]
        grid_sizes = [grid_size] * num_dims if isinstance(grid_size, int) else list(grid_size)
        if len(grid_sizes) != num_dims:
            raise RuntimeError("grid_size length disagrees with num_dims")
        super().__init__(base_kernel, create_grid(grid_sizes, bounds), interpolation_mode=True)
        self.grid_is_dynamic = grid_bounds is None
        self.grid_sizes = tuple(grid_sizes)
        self.register_buffer("grid_bounds", torch.tensor(bounds, dtype=torch.float64))
        self.register_buffer("has_initialized_grid", torch.tensor(0 if self.grid_is_dynamic else 1, dtype=torch.int32))

    def _tight_grid_bounds(self) -> List[Tuple[float, float]]:
        out = []
        for size, (lo, hi) in zip(self.grid_sizes, self.grid_bounds.tolist()):
            spacing = (hi - lo) / size
            out.append((lo + 2.01 * spacing, hi - 2.01 * spacing))
        return out

    def _update_dynamic_grid(self, x1: torch.Tensor, x2: torch.Tensor) -> None:
        """Refit the grid to the inputs when it has none yet or they leave it."""
        if not self.grid_is_dynamic:
            return
        x = x1 if x1 is x2 else torch.cat([x1.reshape(-1, x1.shape[-1]), x2.reshape(-1, x2.shape[-1])])
        x = x.detach().reshape(-1, x.shape[-1])
        mins, maxs = x.min(0).values.tolist(), x.max(0).values.tolist()
        tight = self._tight_grid_bounds()
        if int(self.has_initialized_grid) == 1 and all(
                tight[d][0] <= mins[d] and maxs[d] <= tight[d][1] for d in range(self.num_dims)):
            return
        spacings = [(maxs[d] - mins[d]) / (self.grid_sizes[d] - 4.02) for d in range(self.num_dims)]
        bounds = [(mins[d] - 2.01 * spacings[d], maxs[d] + 2.01 * spacings[d]) for d in range(self.num_dims)]
        self.grid_bounds = torch.tensor(bounds, dtype=torch.float64, device=self.grid_bounds.device)
        self.update_grid(create_grid(self.grid_sizes, bounds, extend=False, dtype=x1.dtype, device=x1.device))
        self.has_initialized_grid = torch.ones_like(self.has_initialized_grid)

    def _compute_grid(self, inputs: torch.Tensor, last_dim_is_batch: bool = False):
        if not last_dim_is_batch:
            return Interpolation().interpolate(self.grid, inputs)
        parts = [Interpolation().interpolate([self.grid[d if d < self.num_dims else 0]], inputs[..., d:d + 1])
                 for d in range(inputs.shape[-1])]
        return torch.stack([i for i, _ in parts], -3), torch.stack([v for _, v in parts], -3)

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        self._update_dynamic_grid(x1, x2)
        left_idx, left_val = self._compute_grid(x1, last_dim_is_batch)
        if x1 is x2:
            right_idx, right_val = left_idx, left_val.to(x1.dtype)
            left_val = right_val
        else:
            right_idx, right_val = self._compute_grid(x2, last_dim_is_batch)
            left_val, right_val = left_val.to(x1.dtype), right_val.to(x1.dtype)
        res = InterpolatedLinearOperator(self.grid_covariance(hypers, last_dim_is_batch), left_idx, left_val,
                                         right_idx, right_val)
        return res._diagonal() if diag else res

    def prediction_strategy(self, train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init=None):
        from ..models.exact_prediction_strategies import InterpolatedPredictionStrategy

        return InterpolatedPredictionStrategy(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init)
