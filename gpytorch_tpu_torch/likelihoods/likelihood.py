"""Likelihood base class.  Counterpart of ``gpytorch_tpu/likelihoods/likelihood.py``, as far
as exact GPs need it: ``__call__`` on a MultivariateNormal gives the marginal p(y | x), on a
tensor of function values the conditional p(y | f).  Further positional arguments (the task
indices of a Hadamard likelihood) go to ``marginal`` and ``forward``."""

from __future__ import annotations

import torch

from ..core.module import Module
from ..distributions import MultivariateNormal


class Likelihood(Module):
    def marginal(self, function_dist: MultivariateNormal, *params) -> MultivariateNormal:
        raise NotImplementedError

    def forward(self, function_samples: torch.Tensor, *params):
        raise NotImplementedError

    def __call__(self, input, *params):
        if isinstance(input, MultivariateNormal):
            return self.marginal(input, *params)
        if torch.is_tensor(input):
            return self.forward(input, *params)
        raise NotImplementedError("a likelihood takes a MultivariateNormal or a tensor of function values")
