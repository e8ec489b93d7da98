"""Homoskedastic noise.  Counterpart of ``HomoskedasticNoise`` and
``MultitaskHomoskedasticNoise`` in ``gpytorch_tpu/likelihoods/noise_models.py``: σ²I with
``raw_noise`` of shape batch + (1,), or one σ²_t per task, of shape batch + (num_tasks,),
repeated over the points in the interleaved layout (index i·t + task)."""

from __future__ import annotations

import torch

from ..constraints import GreaterThan
from ..core.module import Module
from ..linop import ConstantDiagLinearOperator, DiagLinearOperator


class _HomoskedasticNoiseBase(Module):
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

    def forward(self, shape: torch.Size):
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
