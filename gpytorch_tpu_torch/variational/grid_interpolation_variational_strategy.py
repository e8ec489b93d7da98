"""Grid-interpolation (SKI) variational strategies.  Counterpart of
``gpytorch_tpu/variational/grid_interpolation_variational_strategy.py`` (Wilson et al. 2016,
arXiv 1611.00336).

The inducing points are a fixed grid U (``utils/grid.py``: ``grid_size`` points a dimension
over ``grid_bounds``, extended one step past each bound), and f(x) = W(x) u is the cubic
interpolation of the inducing values (``utils/interpolation.py``, 4^d weights a point), so
q(f) = N(W m, W S Wᵀ): the mean a gather (``ops/interp.py::left_interp``), the covariance an
``InterpolatedLinearOperator`` over S, and no kernel solve at the data.  q(u) is not
whitened: its prior is p(u) = N(μ_U, K_UU + 1e-3·I) (the JAX package's jitter; a fine grid's
K_UU is near-singular), so its KL reads K_UU⁻¹ and log|K_UU + 1e-3·I| by a dense Cholesky
factor up to ``settings.max_cholesky_size`` points and above it by mBCG on the lazy kernel
operator, whose products and backward above ``max_eager_kernel_size``² points go to the fused
kernels (``kernel_matvec``, ``kernel_bwd_fused``).

``AdditiveGridInterpolationVariationalStrategy``: f(x) = Σ_d f_d(x_d) over one shared 1-D
grid, q(u) batched over the ``num_dim`` input dimensions, optionally weighted by learned
``mixing_params``.  Its prior is the 1-D K_UU repeated over that batch
(``BatchRepeatLinearOperator``: the mBCG products fold the batch into the columns of one
product).  With ``sum_output`` q(f) is the sum Σ_d W_d S_d W_dᵀ, one interpolated operator over
the block-diagonal S with the dimensions' indices offset by d·m; without, one q(f_d) a
dimension.

The grid is held in buffers (``grid_0``, …) so that ``load_jax_params`` can carry the JAX
package's grid (which it keeps in float32 even under x64) with ``<strategy>.grid``, and
``.to()``/``.double()`` move it with the module.
"""

from __future__ import annotations

from typing import List

import torch

from ..distributions import Delta, MultivariateNormal
from ..linop import BlockDiagLinearOperator, InterpolatedLinearOperator
from ..ops.interp import left_interp
from ..utils.grid import create_data_from_grid, create_grid
from ..utils.interpolation import Interpolation
from ._variational_strategy import _VariationalStrategy

# the prior's jitter (gpytorch_tpu/variational/grid_interpolation_variational_strategy.py:58)
_GRID_JITTER = 1e-3


class GridInterpolationVariationalStrategy(_VariationalStrategy):
    def __init__(self, model, grid_size: int, grid_bounds, variational_distribution):
        grid_bounds = [tuple(b) for b in grid_bounds]
        grids = create_grid([int(grid_size)] * len(grid_bounds), grid_bounds, extend=True)
        super().__init__(model, create_data_from_grid(grids), variational_distribution, learn_inducing_locations=False)
        self.num_grid_dims = len(grids)
        self.grid_size = int(grid_size)
        self._set_grid(grids)

    @property
    def grids(self) -> List[torch.Tensor]:
        return [getattr(self, f"grid_{d}") for d in range(self.num_grid_dims)]

    def _set_grid(self, grids) -> None:
        for d, proj in enumerate(grids):
            self.register_buffer(f"grid_{d}", torch.as_tensor(proj))

    def update_grid(self, grids) -> "GridInterpolationVariationalStrategy":
        """New 1-D grids (their own dtype), and the inducing points made from them."""
        self._set_grid(grids)
        self.inducing_points = create_data_from_grid(self.grids).to(self.inducing_points)
        self.clear_caches()
        return self

    def _compute_grid(self, inputs):
        """The cubic interpolation (indices, values), each (…, n, 4^d), broadcast to q(u)'s batch."""
        n, d = inputs.shape[-2:]
        batch = inputs.shape[:-2]
        idx, vals = Interpolation().interpolate(self.grids, inputs.reshape(-1, d))
        idx, vals = idx.reshape(batch + (n, -1)), vals.reshape(batch + (n, -1))
        vd_batch = tuple(self._variational_distribution.batch_shape)
        if len(batch) != len(vd_batch):
            target = torch.broadcast_shapes(batch, vd_batch)
            idx, vals = idx.expand(target + idx.shape[-2:]), vals.expand(target + vals.shape[-2:])
        return idx, vals

    def prior_distribution(self, model=None) -> MultivariateNormal:
        """N(μ_U, K_UU + 1e-3·I), K_UU lazy above ``max_eager_kernel_size``²."""
        out = self._resolve_model(model).forward(self.inducing_points)
        return MultivariateNormal(out.loc, out.lazy_covariance_matrix.evaluate_kernel().add_jitter(_GRID_JITTER))

    def forward(self, x, inducing_points, inducing_values, variational_inducing_covar=None, model=None, **kwargs):
        if variational_inducing_covar is None:
            raise RuntimeError("GridInterpolationVariationalStrategy is only compatible with Gaussian variational "
                               "distributions (got a Delta).")
        idx, vals = self._compute_grid(x)
        pred_mean = left_interp(idx, vals, inducing_values.unsqueeze(-1)).squeeze(-1)
        return MultivariateNormal(pred_mean, InterpolatedLinearOperator(variational_inducing_covar, idx, vals, idx, vals))


class AdditiveGridInterpolationVariationalStrategy(GridInterpolationVariationalStrategy):
    def __init__(self, model, grid_size: int, grid_bounds, num_dim: int, variational_distribution,
                 mixing_params: bool = False, sum_output: bool = True):
        if len(list(grid_bounds)) != 1:
            raise ValueError("Additive grid strategy uses a single shared 1-d grid (one bound pair)")
        super().__init__(model, grid_size, grid_bounds, variational_distribution)
        self.num_dim = int(num_dim)
        self.sum_output = bool(sum_output)
        if mixing_params:
            Z = self.inducing_points
            self.register_parameter("mixing_params", torch.nn.Parameter(
                torch.full((self.num_dim,), 1.0 / self.num_dim, dtype=Z.dtype, device=Z.device)))

    def _compute_grid(self, inputs):
        """The 1-D interpolation of each input dimension, (num_dim, n, 4), weighted by the mixing
        parameters where there are any."""
        n, d = inputs.shape[-2:]
        idx, vals = Interpolation().interpolate(self.grids, inputs.mT.reshape(-1, 1))  # dimension-major
        idx, vals = idx.reshape(d, n, -1), vals.reshape(d, n, -1)
        if hasattr(self, "mixing_params"):
            vals = vals * self.mixing_params.reshape(-1, 1, 1)
        return idx, vals

    def prior_distribution(self, model=None) -> MultivariateNormal:
        """The 1-D prior repeated over the ``num_dim`` batch (no copy)."""
        out = super().prior_distribution(model)
        covar = out.lazy_covariance_matrix
        return MultivariateNormal(out.loc.expand((self.num_dim,) + out.loc.shape[-1:]),
                                  covar.expand((self.num_dim,) + tuple(covar.shape[-2:])))

    def kl_divergence(self, model=None) -> torch.Tensor:
        return super().kl_divergence(model).sum(0)

    def forward(self, x, inducing_points, inducing_values, variational_inducing_covar=None, model=None, **kwargs):
        if x.ndim != 2:
            raise RuntimeError("AdditiveGridInterpolationVariationalStrategy expects a 2d input")
        n, d = x.shape
        if d != self.num_dim:
            raise RuntimeError(f"Expected {self.num_dim} input dims, got {d}")
        idx, vals = self._compute_grid(x)  # (d, n, 4)
        if not self.sum_output:
            pred_mean = left_interp(idx, vals, inducing_values.unsqueeze(-1)).squeeze(-1)  # (d, n)
            if variational_inducing_covar is None:
                return Delta(pred_mean)
            return MultivariateNormal(pred_mean, InterpolatedLinearOperator(variational_inducing_covar, idx, vals,
                                                                            idx, vals))
        # Σ_d W_d S_d W_dᵀ = W̃ blockdiag(S_1 … S_d) W̃ᵀ, W̃'s column indices offset by d·m
        m = self.inducing_points.shape[-2]
        offsets = (torch.arange(d, device=idx.device) * m).reshape(-1, 1, 1)
        idx_comb = (idx + offsets).transpose(0, 1).reshape(n, -1)  # (n, d·4)
        vals_comb = vals.transpose(0, 1).reshape(n, -1)
        pred_mean = left_interp(idx_comb, vals_comb, inducing_values.reshape(-1, 1)).squeeze(-1)
        if variational_inducing_covar is None:
            return Delta(pred_mean)
        return MultivariateNormal(pred_mean, InterpolatedLinearOperator(
            BlockDiagLinearOperator(variational_inducing_covar), idx_comb, vals_comb, idx_comb, vals_comb))
