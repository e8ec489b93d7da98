"""Model lists.  Counterpart of ``gpytorch_tpu/models/model_list.py``.

``IndependentModelList`` holds models that share nothing, each with its own likelihood (say,
two outcomes with different kernels on the same inputs).  The models are an
``nn.ModuleList``, so ``parameters()`` yields each parameter once and ``train()``/``eval()``
reach every model.  A call takes one input (or one tuple of inputs) per model and returns the
list of their outputs; ``likelihood`` is the ``LikelihoodList`` of the models' likelihoods."""

from __future__ import annotations

from torch import nn

from ..core.module import Module
from ..likelihoods import LikelihoodList


def _args(a) -> tuple:
    return tuple(a) if isinstance(a, (list, tuple)) else (a,)


class AbstractModelList(Module):
    def forward_i(self, i, *args, **kwargs):
        raise NotImplementedError

    def likelihood_i(self, i, *args, **kwargs):
        raise NotImplementedError


class IndependentModelList(AbstractModelList):
    def __init__(self, *models):
        super().__init__()
        if not all(hasattr(m, "likelihood") for m in models):
            raise ValueError("IndependentModelList requires models with a likelihood")
        self.models = nn.ModuleList(models)

    @property
    def likelihood(self) -> LikelihoodList:
        return LikelihoodList(*[m.likelihood for m in self.models])

    def forward_i(self, i, *args, **kwargs):
        return self.models[i].forward(*args, **kwargs)

    def likelihood_i(self, i, *args, **kwargs):
        return self.models[i].likelihood(*args, **kwargs)

    def forward(self, *args):
        return [m.forward(*_args(a)) for m, a in zip(self.models, args)]

    def __call__(self, *args):
        return [m(*_args(a)) for m, a in zip(self.models, args)]

    def get_fantasy_model(self, inputs, targets, **kwargs) -> "IndependentModelList":
        """The list of each model's fantasy model on its own (inputs, targets)."""
        return IndependentModelList(*[m.get_fantasy_model(x, y, **kwargs)
                                      for m, x, y in zip(self.models, inputs, targets)])
