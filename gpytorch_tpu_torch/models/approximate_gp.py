"""ApproximateGP — a GP whose posterior is a variational q(f).  Counterpart of
``gpytorch_tpu/models/approximate_gp.py``: the subclass defines ``forward(x)`` (the prior)
and hands a variational strategy to ``__init__``; calling the model returns q(f(x)) from
that strategy, to which it passes itself.  ``get_fantasy_model`` is the strategy's online
variational conditioning."""

from __future__ import annotations

import torch

from .gp import GP


class ApproximateGP(GP):
    def __init__(self, variational_strategy):
        super().__init__()
        self.variational_strategy = variational_strategy

    def forward(self, x: torch.Tensor):
        raise NotImplementedError

    def get_fantasy_model(self, inputs: torch.Tensor, targets: torch.Tensor, **kwargs):
        """An exact GP over the inducing points' pseudo-observations and (``inputs``,
        ``targets``) (``_VariationalStrategy.get_fantasy_model``)."""
        return self.variational_strategy.get_fantasy_model(inputs, targets, model=self, **kwargs)

    def __call__(self, inputs: torch.Tensor, prior: bool = False, **kwargs):
        if inputs.ndim == 1:
            inputs = inputs.unsqueeze(-1)
        return self.variational_strategy(inputs, prior=prior, model=self, **kwargs)
