"""PiecewisePolynomialKernel — compactly supported Wendland functions of r = ‖(x − x')/ℓ‖,
q ∈ {0, 1, 2, 3}.  Counterpart of ``gpytorch_tpu/kernels/piecewise_polynomial_kernel.py``;
no fused product (it streams through the lazy operator's blocks of rows)."""

from __future__ import annotations

import math

import torch

from .kernel import Kernel
from .stationary import _dist, _divided, _last_dim_batch


def _fmax(r, j: int, q: int):
    return torch.clamp_min(1.0 - r, 0.0) ** (j + q)


def _get_cov(r, j: int, q: int):
    if q == 0:
        return _fmax(r, j, q)
    if q == 1:
        return _fmax(r, j, q) * ((j + 1) * r + 1)
    if q == 2:
        return _fmax(r, j, q) * ((j**2 + 4 * j + 3) / 3.0 * r**2 + (3 * j + 6) / 3.0 * r + 1)
    return _fmax(r, j, q) * ((j**3 + 9 * j**2 + 23 * j + 15) / 15.0 * r**3 + (6 * j**2 + 36 * j + 45) / 15.0 * r**2
                             + (15 * j + 45) / 15.0 * r + 1)


class PiecewisePolynomialKernel(Kernel):
    has_lengthscale = True

    def __init__(self, q: int = 2, **kwargs):
        if q not in {0, 1, 2, 3}:
            raise ValueError("q expected to be 0, 1, 2 or 3")
        super().__init__(**kwargs)
        self.q = int(q)

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        # j from the number of input dimensions each matrix sees: one with last_dim_is_batch
        dims = 1 if last_dim_is_batch else x1.shape[-1]
        j = math.floor(dims / 2.0) + self.q + 1
        x1, x2 = _last_dim_batch(*_divided(x1, x2, hypers["lengthscale"]), last_dim_is_batch)
        return _get_cov(_dist(x1, x2, diag), j, self.q)
