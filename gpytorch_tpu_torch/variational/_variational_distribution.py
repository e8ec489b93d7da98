"""Variational distributions q(u) over the inducing values.  Counterpart of
``gpytorch_tpu/variational/_variational_distribution.py``: the full-covariance
(``CholeskyVariationalDistribution``), diagonal (``MeanFieldVariationalDistribution``) and
point-mass (``DeltaVariationalDistribution``) forms, each with an optional ``batch_shape``
(one q(u) per batch element: a deep GP's hidden layer has one per output dimension).

``initialize_variational_distribution`` sets q(u) from the prior p(u) on the strategy's
first call, its mean perturbed by ``mean_init_std`` times standard-normal draws.  The JAX
package draws those with ``jax.random``; here they come from ``generator`` (by default a CPU
generator seeded with 0, drawn in float64 and moved to the parameters' device and dtype, so
that every device and precision starts from the same q(u)).  The two packages' draws
differ: carry an initialised state across (``load_jax_params``) to compare them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.module import Module
from ..distributions import Delta, MultivariateNormal
from ..linop import CholLinearOperator, DiagLinearOperator


class _VariationalDistribution(Module):
    def __init__(self, num_inducing_points: int, batch_shape: Sequence[int] = (), mean_init_std: float = 1e-3):
        super().__init__()
        self.num_inducing_points = int(num_inducing_points)
        self.batch_shape = tuple(int(b) for b in batch_shape)
        self.mean_init_std = float(mean_init_std)

    def shape(self) -> tuple:
        return self.batch_shape + (self.num_inducing_points,)

    def forward(self):
        raise NotImplementedError

    def initialize_variational_distribution(self, prior_dist: MultivariateNormal,
                                            generator: Optional[torch.Generator] = None) -> None:
        raise NotImplementedError

    def _perturbed_mean(self, prior_dist: MultivariateNormal, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The prior mean plus ``mean_init_std`` · N(0, I) draws from ``generator``."""
        mean = prior_dist.mean
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        noise = torch.randn(mean.shape, generator=generator, dtype=torch.float64, device=generator.device)
        return mean + self.mean_init_std * noise.to(mean.device, mean.dtype)


def _assign(param: torch.Tensor, value: torch.Tensor) -> None:
    """param ← value, broadcast to the parameter's shape (no autograd history)."""
    with torch.no_grad():
        param.copy_(value.expand_as(param))


class CholeskyVariationalDistribution(_VariationalDistribution):
    """q(u) = N(m, L Lᵀ) with L the lower triangle of ``chol_variational_covar``."""

    def __init__(self, num_inducing_points: int, batch_shape: Sequence[int] = (), mean_init_std: float = 1e-3):
        super().__init__(num_inducing_points, batch_shape, mean_init_std)
        m = self.num_inducing_points
        self.register_parameter("variational_mean", torch.nn.Parameter(torch.zeros(self.shape())))
        self.register_parameter("chol_variational_covar",
                                torch.nn.Parameter(torch.eye(m).expand(self.batch_shape + (m, m)).clone()))

    def forward(self) -> MultivariateNormal:
        return MultivariateNormal(self.variational_mean, CholLinearOperator(torch.tril(self.chol_variational_covar)))

    def initialize_variational_distribution(self, prior_dist, generator=None):
        _assign(self.variational_mean, self._perturbed_mean(prior_dist, generator))
        _assign(self.chol_variational_covar, prior_dist.lazy_covariance_matrix.evaluate_kernel().cholesky().to_dense())


class MeanFieldVariationalDistribution(_VariationalDistribution):
    """q(u) = N(m, diag(s²)) with s = |raw_variational_stddev| + 1e-8."""

    def __init__(self, num_inducing_points: int, batch_shape: Sequence[int] = (), mean_init_std: float = 1e-3):
        super().__init__(num_inducing_points, batch_shape, mean_init_std)
        self.register_parameter("variational_mean", torch.nn.Parameter(torch.zeros(self.shape())))
        self.register_parameter("raw_variational_stddev", torch.nn.Parameter(torch.ones(self.shape())))

    @property
    def variational_stddev(self) -> torch.Tensor:
        return torch.abs(self.raw_variational_stddev) + 1e-8

    def forward(self) -> MultivariateNormal:
        return MultivariateNormal(self.variational_mean, DiagLinearOperator(self.variational_stddev ** 2))

    def initialize_variational_distribution(self, prior_dist, generator=None):
        _assign(self.variational_mean, self._perturbed_mean(prior_dist, generator))
        _assign(self.raw_variational_stddev, prior_dist.variance.sqrt())


class DeltaVariationalDistribution(_VariationalDistribution):
    """q(u) = δ(u − m): MAP inducing values."""

    def __init__(self, num_inducing_points: int, batch_shape: Sequence[int] = (), mean_init_std: float = 1e-3):
        super().__init__(num_inducing_points, batch_shape, mean_init_std)
        self.register_parameter("variational_mean", torch.nn.Parameter(torch.zeros(self.shape())))

    def forward(self) -> Delta:
        return Delta(self.variational_mean)

    def initialize_variational_distribution(self, prior_dist, generator=None):
        _assign(self.variational_mean, self._perturbed_mean(prior_dist, generator))
