"""Noise covariance models.  Counterpart of ``gpytorch_tpu/likelihoods/noise_models.py``.

A noise model is called as ``noise(*params, shape=...)`` and returns the noise covariance
over the points of ``shape`` (its batch and, last, the number of points):

* ``HomoskedasticNoise``: σ²I with ``raw_noise`` of shape batch + (1,);
  ``MultitaskHomoskedasticNoise`` one σ²_t per task, of shape batch + (num_tasks,),
  repeated over the points in the interleaved layout (index i·t + task);
* ``FixedGaussianNoise``: a given noise per point, floored at ``settings.min_fixed_noise``;
  for a number of points other than its own (test points) the zero operator, a no-noise
  prediction, unless the call gives ``noise=``;
* ``HeteroskedasticNoise``: the noise of each point read from the mean of a second model
  of the inputs (``params``), through a constraint.
"""

from __future__ import annotations

import torch

from .. import settings
from ..constraints import GreaterThan
from ..core.module import Module
from ..linop import ConstantDiagLinearOperator, DiagLinearOperator, ZeroLinearOperator


class Noise(Module):
    """A noise covariance model: ``forward(*params, shape=None, **kwargs)``."""

    def forward(self, *params, shape=None, **kwargs):
        raise NotImplementedError


class _HomoskedasticNoiseBase(Noise):
    def __init__(self, noise_prior=None, noise_constraint=None, batch_shape=(), num_tasks: int = 1):
        super().__init__()
        self.batch_shape = tuple(int(b) for b in batch_shape)
        self.num_tasks = int(num_tasks)
        self.register_parameter("raw_noise", torch.nn.Parameter(torch.zeros(self.batch_shape + (self.num_tasks,))))
        self.register_constraint("raw_noise", noise_constraint or GreaterThan(1e-4))
        if noise_prior is not None:
            self.register_prior("noise_prior", noise_prior, lambda m: m.noise,
                                lambda m, v: m._set_constrained("raw_noise", v))

    @property
    def noise(self) -> torch.Tensor:
        return self._constrained("raw_noise")

    @noise.setter
    def noise(self, value) -> None:
        self._set_constrained("raw_noise", value)

    def forward(self, *params, shape):
        """The noise covariance over ``shape[-1]`` points (of every task)."""
        noise = self.noise
        if self.num_tasks == 1:
            return ConstantDiagLinearOperator(noise, shape[-1])
        n = shape[-1]
        return DiagLinearOperator(noise.unsqueeze(-2).expand(noise.shape[:-1] + (n, self.num_tasks)).flatten(-2))


class HomoskedasticNoise(_HomoskedasticNoiseBase):
    """σ²I."""

    def __init__(self, noise_prior=None, noise_constraint=None, batch_shape=()):
        super().__init__(noise_prior, noise_constraint, batch_shape, num_tasks=1)


class MultitaskHomoskedasticNoise(_HomoskedasticNoiseBase):
    """One σ²_t per task (``gpytorch_tpu/likelihoods/noise_models.py:81``)."""

    def __init__(self, num_tasks: int, noise_prior=None, noise_constraint=None, batch_shape=()):
        super().__init__(noise_prior, noise_constraint, batch_shape, num_tasks=num_tasks)


class FixedGaussianNoise(Noise):
    """A given noise per point (a buffer ``noise`` of shape batch + (n,)), floored at
    ``settings.min_fixed_noise`` of its dtype."""

    def __init__(self, noise: torch.Tensor):
        super().__init__()
        self.register_buffer("noise", torch.as_tensor(noise))

    def forward(self, *params, shape=None, noise=None):
        if noise is not None:
            return DiagLinearOperator(_floored(torch.as_tensor(noise, dtype=self.noise.dtype, device=self.noise.device)))
        if shape is None or shape[-1] == self.noise.shape[-1]:
            return DiagLinearOperator(_floored(self.noise))
        shape = tuple(shape)
        return ZeroLinearOperator(shape + shape[-1:], dtype=self.noise.dtype, device=self.noise.device)


def _floored(noise: torch.Tensor) -> torch.Tensor:
    return noise.clamp_min(settings.min_fixed_noise.value(noise.dtype))


class HeteroskedasticNoise(Noise):
    """Noise from a second model of the inputs: the constrained mean of
    ``noise_model(*params)`` (its columns ``noise_indices`` of a multi-output mean), read
    in eval mode."""

    def __init__(self, noise_model, noise_indices=None, noise_constraint=None):
        super().__init__()
        self.noise_model = noise_model
        self.noise_indices = noise_indices
        self.noise_constraint = noise_constraint or GreaterThan(1e-4)

    def forward(self, *params, shape=None):
        from ..distributions import MultivariateNormal

        training = self.noise_model.training
        self.noise_model.eval()
        try:
            output = self.noise_model(*params)
        finally:
            self.noise_model.train(training)
        if not isinstance(output, MultivariateNormal):
            raise RuntimeError("noise_model must return a MultivariateNormal")
        log_noise = output.mean if self.noise_indices is None else output.mean[..., self.noise_indices]
        return DiagLinearOperator(self.noise_constraint.transform(log_noise))
