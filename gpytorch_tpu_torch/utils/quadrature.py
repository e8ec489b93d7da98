"""Gauss–Hermite quadrature.  Counterpart of ``gpytorch_tpu/utils/quadrature.py``."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import settings
from ..core.module import Module


class GaussHermiteQuadrature1D(Module):
    """E[func(f)] for f ~ N(μ, σ²) elementwise over a distribution's mean and variance:
    Σ_i w_i func(μ + σ x_i) at the probabilists' Hermite nodes x_i
    (``settings.num_gauss_hermite_locs`` of them), the weights normalised to sum to 1.
    The nodes are the leading dimension of what ``func`` is given."""

    def __init__(self, num_locs=None):
        super().__init__()
        self.num_locs = int(settings.num_gauss_hermite_locs.value() if num_locs is None else num_locs)
        locs, weights = np.polynomial.hermite_e.hermegauss(self.num_locs)
        self.register_buffer("locations", torch.as_tensor(locs))
        self.register_buffer("weights", torch.as_tensor(weights / math.sqrt(2 * math.pi)))

    def forward(self, func, gaussian_dists):
        mean = gaussian_dists.mean
        std = gaussian_dists.variance.sqrt()
        locs = self.locations.to(mean.device, mean.dtype).reshape((self.num_locs,) + (1,) * mean.ndim)
        vals = func(mean + std * locs)
        w = self.weights.to(vals.device, vals.dtype).reshape((self.num_locs,) + (1,) * (vals.ndim - 1))
        return (vals * w).sum(0)
