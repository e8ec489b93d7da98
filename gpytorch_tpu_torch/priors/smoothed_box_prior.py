"""SmoothedBoxPrior: uniform on [a, b] with Gaussian tails of width σ outside.
Counterpart of ``gpytorch_tpu/priors/smoothed_box_prior.py``: the density is
N(dist(x, [a, b]); 0, σ²) / (1 + (b − a) / (√(2π) σ)), so that it integrates to one; ``sample``
draws uniformly on [a, b], as the JAX package does."""

from __future__ import annotations

import math

import torch

from .prior import Prior
from .torch_priors import _buffer


class SmoothedBoxPrior(Prior):
    def __init__(self, a, b, sigma=0.01):
        super().__init__()
        a, b = _buffer(a), _buffer(b)
        self.register_buffer("a", torch.minimum(a, b))
        self.register_buffer("b", torch.maximum(a, b))
        self.register_buffer("sigma", _buffer(sigma))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        centre, radius = (self.a + self.b) / 2, (self.b - self.a) / 2
        dist = ((x - centre).abs() - radius).clamp_min(0.0)
        log_mass = torch.log1p((self.b - self.a) / (math.sqrt(2 * math.pi) * self.sigma))
        return -0.5 * (dist / self.sigma) ** 2 - (torch.log(math.sqrt(2 * math.pi) * self.sigma) + log_mass)

    def sample(self, sample_shape=(), generator=None) -> torch.Tensor:
        u = torch.rand(tuple(sample_shape) + self.a.shape, generator=generator, dtype=self.a.dtype,
                       device=self.a.device)
        return self.a + (self.b - self.a) * u
