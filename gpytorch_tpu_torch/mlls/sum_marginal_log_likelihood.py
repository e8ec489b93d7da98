"""The summed objective of an ``IndependentModelList``.  Counterpart of
``gpytorch_tpu/mlls/sum_marginal_log_likelihood.py``: one ``mll_cls`` per model, on that
model and its likelihood, summed over the models' (output, target) pairs.  Further positional
arguments are sequences, one entry per model, passed in lockstep."""

from __future__ import annotations

from torch import nn

from .exact_marginal_log_likelihood import ExactMarginalLogLikelihood
from .marginal_log_likelihood import MarginalLogLikelihood


class SumMarginalLogLikelihood(MarginalLogLikelihood):
    def __init__(self, likelihood, model, mll_cls=ExactMarginalLogLikelihood):
        super().__init__(likelihood, model)
        self.mlls = nn.ModuleList([mll_cls(m.likelihood, m) for m in model.models])

    def forward(self, outputs, targets, *params):
        values = [mll(output, target, *p) for mll, output, target, *p in zip(self.mlls, outputs, targets, *params)]
        return sum(values[1:], values[0])
