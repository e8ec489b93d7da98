"""The standard priors on ``torch.distributions``.

Counterpart of ``gpytorch_tpu/priors/torch_priors.py``: NormalPrior, HalfNormalPrior,
LogNormalPrior, UniformPrior, HalfCauchyPrior, GammaPrior and MultivariateNormalPrior, with
the JAX package's buffer names.  ``sample`` draws from an explicit ``torch.Generator`` (in
place of a JAX key), by inverse transforms of standard normal and uniform draws, and for
the gamma prior by Marsaglia and Tsang's rejection method, since ``torch.distributions``
takes no generator.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import distributions as td

from .prior import Prior


def _buffer(value) -> torch.Tensor:
    value = torch.as_tensor(value)
    return value if value.is_floating_point() else value.to(torch.get_default_dtype())


class _LocScalePrior(Prior):
    def __init__(self, loc, scale):
        super().__init__()
        self.register_buffer("loc", _buffer(loc))
        self.register_buffer("scale", _buffer(scale))

    def _normal(self, sample_shape, generator):
        shape = tuple(sample_shape) + torch.broadcast_shapes(self.loc.shape, self.scale.shape)
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + self.scale * eps


class NormalPrior(_LocScalePrior):
    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return self.scale**2

    def distribution(self):
        return td.Normal(self.loc, self.scale, validate_args=False)

    def sample(self, sample_shape=(), generator=None):
        return self._normal(sample_shape, generator)


class LogNormalPrior(_LocScalePrior):
    @property
    def mean(self):
        return torch.exp(self.loc + self.scale**2 / 2)

    def distribution(self):
        return td.LogNormal(self.loc, self.scale, validate_args=False)

    def sample(self, sample_shape=(), generator=None):
        return torch.exp(self._normal(sample_shape, generator))


class HalfNormalPrior(Prior):
    def __init__(self, scale):
        super().__init__()
        self.register_buffer("scale", _buffer(scale))

    def distribution(self):
        return td.HalfNormal(self.scale, validate_args=False)

    def sample(self, sample_shape=(), generator=None):
        shape = tuple(sample_shape) + self.scale.shape
        return self.scale * torch.randn(shape, generator=generator, dtype=self.scale.dtype, device=self.scale.device).abs()


class HalfCauchyPrior(Prior):
    def __init__(self, scale):
        super().__init__()
        self.register_buffer("scale", _buffer(scale))

    def distribution(self):
        return td.HalfCauchy(self.scale, validate_args=False)

    def sample(self, sample_shape=(), generator=None):
        shape = tuple(sample_shape) + self.scale.shape
        u = torch.rand(shape, generator=generator, dtype=self.scale.dtype, device=self.scale.device)
        return self.scale * torch.tan(0.5 * math.pi * u)  # |Cauchy| by its inverse CDF


class UniformPrior(Prior):
    def __init__(self, a, b):
        super().__init__()
        self.register_buffer("low", _buffer(a))
        self.register_buffer("high", _buffer(b))

    def distribution(self):
        return td.Uniform(self.low, self.high, validate_args=False)

    def sample(self, sample_shape=(), generator=None):
        shape = tuple(sample_shape) + torch.broadcast_shapes(self.low.shape, self.high.shape)
        u = torch.rand(shape, generator=generator, dtype=self.low.dtype, device=self.low.device)
        return self.low + (self.high - self.low) * u


def _standard_gamma(concentration: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Gamma(α, 1) draws of α's shape by Marsaglia and Tsang (2000): for α ≥ 1, v = (1 + x/√(9d))³
    with d = α − 1/3 and x ~ N(0, 1), kept when log u < x²/2 + d − dv + d log v; for α < 1,
    a Gamma(α + 1) draw times u^(1/α)."""
    boost = concentration < 1
    d = torch.where(boost, concentration + 1, concentration) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(d)
    todo = torch.ones_like(d, dtype=torch.bool)
    while bool(todo.any()):
        x = torch.randn(d.shape, generator=generator, dtype=d.dtype, device=d.device)
        u = torch.rand(d.shape, generator=generator, dtype=d.dtype, device=d.device)
        v = (1.0 + c * x) ** 3
        log_v = torch.log(torch.clamp_min(v, torch.finfo(d.dtype).tiny))
        accept = todo & (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
        out = torch.where(accept, d * v, out)
        todo = todo & ~accept
    u = torch.rand(d.shape, generator=generator, dtype=d.dtype, device=d.device)
    return torch.where(boost, out * u ** (1.0 / concentration), out)


class GammaPrior(Prior):
    def __init__(self, concentration, rate):
        super().__init__()
        self.register_buffer("concentration", _buffer(concentration))
        self.register_buffer("rate", _buffer(rate))

    @property
    def mean(self):
        return self.concentration / self.rate

    def distribution(self):
        return td.Gamma(self.concentration, self.rate, validate_args=False)

    def sample(self, sample_shape=(), generator=None):
        shape = tuple(sample_shape) + torch.broadcast_shapes(self.concentration.shape, self.rate.shape)
        return _standard_gamma(self.concentration.expand(shape), generator) / self.rate


class MultivariateNormalPrior(Prior):
    def __init__(self, mean, covariance_matrix):
        super().__init__()
        self.register_buffer("loc", _buffer(mean))
        self.register_buffer("covariance", _buffer(covariance_matrix))

    def distribution(self):
        return td.MultivariateNormal(self.loc, covariance_matrix=self.covariance, validate_args=False)

    def sample(self, sample_shape: Sequence[int] = (), generator=None):
        L = torch.linalg.cholesky(self.covariance)
        shape = tuple(sample_shape) + self.loc.shape
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + (L @ eps.unsqueeze(-1)).squeeze(-1)
