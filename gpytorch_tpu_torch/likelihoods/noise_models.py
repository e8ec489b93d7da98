"""Homoskedastic noise σ²I.  Counterpart of ``HomoskedasticNoise`` in
``gpytorch_tpu/likelihoods/noise_models.py``."""

from __future__ import annotations

import torch

from ..constraints import GreaterThan
from ..core.module import Module
from ..linop import ConstantDiagLinearOperator


class HomoskedasticNoise(Module):
    def __init__(self, noise_prior=None, noise_constraint=None):
        super().__init__()
        self.register_parameter("raw_noise", torch.nn.Parameter(torch.zeros(1)))
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

    def forward(self, shape: torch.Size) -> ConstantDiagLinearOperator:
        """The noise covariance over ``shape[-1]`` points."""
        return ConstantDiagLinearOperator(self.noise, shape[-1])
