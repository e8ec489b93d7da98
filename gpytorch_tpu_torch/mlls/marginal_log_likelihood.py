"""MLL base.  Counterpart of ``gpytorch_tpu/mlls/marginal_log_likelihood.py``."""

from __future__ import annotations

from ..core.module import Module


class MarginalLogLikelihood(Module):
    def __init__(self, likelihood, model):
        super().__init__()
        self.likelihood = likelihood
        self.model = model

    def forward(self, output, target, **kwargs):
        raise NotImplementedError
