"""HorseshoePrior: θ ~ N(0, λ² τ²) with λ ~ C⁺(0, 1) and τ the prior's scale.

Counterpart of ``gpytorch_tpu/priors/horseshoe_prior.py``.  The density has no closed form;
Carvalho, Polson and Scott (2010) bound it for τ = 1 by

    K/2 · log(1 + 4/θ²) < p(θ) < K · log(1 + 2/θ²),    K = 1/√(2π³),

and ``log_prob`` is the log of the midpoint of the bounds at x/τ, less log τ.  (The JAX
package swaps the two logarithms' arguments and takes 1/(2π^{3/2}) for K; its value lies
below the lower bound.)  ``sample`` draws λ = |Cauchy| by its inverse CDF and θ = λ τ ε,
ε ~ N(0, 1), from one generator."""

from __future__ import annotations

import math

import torch

from .prior import Prior
from .torch_priors import _buffer

_LOG_K = -0.5 * math.log(2 * math.pi**3)


class HorseshoePrior(Prior):
    def __init__(self, scale):
        super().__init__()
        self.register_buffer("scale", _buffer(scale))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        theta2 = (x / self.scale) ** 2
        lower = 0.5 * torch.log1p(4.0 / theta2)
        upper = torch.log1p(2.0 / theta2)
        return _LOG_K + torch.log((lower + upper) / 2) - torch.log(self.scale)

    def sample(self, sample_shape=(), generator=None) -> torch.Tensor:
        shape = tuple(sample_shape) + self.scale.shape
        kw = dict(generator=generator, dtype=self.scale.dtype, device=self.scale.device)
        local = torch.tan(0.5 * math.pi * torch.rand(shape, **kw))
        return torch.randn(shape, **kw) * local * self.scale
