"""GridKernel — a stationary kernel on a Cartesian grid: Toeplitz in each dimension,
Kronecker across dimensions.

Counterpart of ``gpytorch_tpu/kernels/grid_kernel.py``.  The grid is held in buffers, one
1D grid a dimension (``grid_0``, ``grid_1``, …), so that ``load_jax_params`` can carry the
JAX package's grid over and ``.to()``/``.double()`` move it with the module.  On the grid
(or always in ``interpolation_mode``) the covariance K_UU is a structured operator
(``returns_lazy_structure``): the Toeplitz column k(g₀, g) of each dimension under
``settings.use_toeplitz`` (else the dense per-dimension matrix), and their Kronecker
product in reversed order, so that the first dimension varies fastest
(``utils/grid.py::create_data_from_grid``).  With ``last_dim_is_batch`` the per-dimension
matrices are stacked densely instead, (d, m, m), one a dimension (``gpytorch_tpu/kernels/
grid_kernel.py:58-90``).
"""

from __future__ import annotations

from typing import List

import torch

from .. import settings
from ..linop import DenseLinearOperator, KroneckerProductLinearOperator, ToeplitzLinearOperator
from ..utils.grid import convert_legacy_grid
from .kernel import Kernel, _flag, sub_hypers


class GridKernel(Kernel):
    returns_lazy_structure = True

    def __init__(self, base_kernel: Kernel, grid, interpolation_mode: bool = False):
        super().__init__()
        self.base_kernel = base_kernel
        self.interpolation_mode = bool(interpolation_mode)
        if torch.is_tensor(grid):
            grid = convert_legacy_grid(grid)
        self.num_dims = len(grid)
        self._set_grid(grid)

    @property
    def grid(self) -> List[torch.Tensor]:
        return [getattr(self, f"grid_{d}") for d in range(self.num_dims)]

    def _set_grid(self, grid) -> None:
        for d, proj in enumerate(grid):
            self.register_buffer(f"grid_{d}", torch.as_tensor(proj))

    def update_grid(self, grid) -> "GridKernel":
        if torch.is_tensor(grid):
            grid = convert_legacy_grid(grid)
        self._set_grid(grid)
        self.clear_caches()
        return self

    def hypers(self):
        return {f"base_kernel.{k}": v for k, v in self.base_kernel.hypers().items()}

    def grid_covariance(self, hypers, last_dim_is_batch: bool = False):
        """K_UU: a Toeplitz (or dense) operator a dimension, and their Kronecker product; with
        ``last_dim_is_batch`` the dimensions' dense matrices stacked, (d, m, m)."""
        base = sub_hypers(hypers, "base_kernel.")
        covars = []
        for proj in self.grid:
            pts = proj.unsqueeze(-1)
            if settings.use_toeplitz.on():
                covars.append(ToeplitzLinearOperator(self.base_kernel.evaluate(base, pts[:1], pts)[..., 0, :]))
            else:
                covars.append(DenseLinearOperator(self.base_kernel.evaluate(base, pts, pts)))
        if last_dim_is_batch:
            return DenseLinearOperator(torch.stack([c.to_dense() for c in covars], -3))
        if len(covars) == 1:
            return covars[0]
        # reversed: the first grid dimension varies fastest
        return KroneckerProductLinearOperator(*covars[::-1])

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        flag = _flag(last_dim_is_batch)
        if diag:
            return self.base_kernel.evaluate(sub_hypers(hypers, "base_kernel."), x1, x2, diag=True, **flag)
        numel = 1
        for g in self.grid:
            numel *= g.shape[0]
        if not (self.interpolation_mode or x1.shape[-2] == x2.shape[-2] == numel):
            return self.base_kernel.evaluate(sub_hypers(hypers, "base_kernel."), x1, x2, **flag)
        return self.grid_covariance(hypers, last_dim_is_batch)
