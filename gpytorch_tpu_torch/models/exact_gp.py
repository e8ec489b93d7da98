"""ExactGP — exact Gaussian-process regression.

Counterpart of ``gpytorch_tpu/models/exact_gp.py``.  In training mode ``__call__`` returns
the prior ``forward``; in eval mode it returns the posterior over the test inputs, from a
prediction strategy built once and cached until ``clear_caches()``, ``train()`` or
``eval()``.  The joint train/test prior is formed lazily and only its test rows are ever
evaluated.

The posterior is differentiable with respect to the test inputs, and with respect to the
hyperparameters through its test side (K**, K*x and μ*): the strategy and its caches are
built without gradients, as under the JAX package's default ``detach_test_caches``.
Serving callers wrap their requests in ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import settings
from ..core.module import Module
from ..distributions import MultivariateNormal
from ..linop import join_rows
from .exact_prediction_strategies import prediction_strategy as _prediction_strategy


class ExactGP(Module):
    """Subclasses define ``forward(x) -> MultivariateNormal`` (the prior).

    ``lanczos_init`` optionally fixes the start block (n, b) of the LOVE Lanczos run;
    by default it is drawn from a CPU generator seeded with 0."""

    def __init__(self, train_inputs, train_targets, likelihood, lanczos_init: Optional[torch.Tensor] = None):
        super().__init__()
        if torch.is_tensor(train_inputs):
            train_inputs = (train_inputs,)
        self.train_inputs = tuple(x.unsqueeze(-1) if x.ndim == 1 else x for x in train_inputs)
        self.train_targets = train_targets
        self.likelihood = likelihood
        self.lanczos_init = lanczos_init

    def forward(self, *inputs) -> MultivariateNormal:
        raise NotImplementedError

    def prediction_strategy(self):
        """The cached prediction strategy (built at first use)."""
        strategy = self._cache.get("prediction_strategy")
        if strategy is None:
            train_prior_dist = self.forward(*self.train_inputs)
            strategy = _prediction_strategy(
                self.train_inputs, train_prior_dist, self.train_targets, self.likelihood, self.lanczos_init
            )
            self._cache["prediction_strategy"] = strategy
        return strategy

    def refresh(self):
        """Build the prediction caches now rather than at the first request: the mean
        cache (one CG solve) and, under ``fast_pred_var`` or ``fast_pred_samples``, the
        LOVE cache.  Returns the prediction strategy that holds them."""
        with torch.no_grad(), settings.cg_tolerance(settings.eval_cg_tolerance.value()):
            strategy = self.prediction_strategy()
            strategy.mean_cache
            if settings.fast_pred_var.on() or settings.fast_pred_samples.on():
                strategy.covar_cache
        return strategy

    def __call__(self, *args) -> MultivariateNormal:
        inputs = tuple(x.unsqueeze(-1) if x.ndim == 1 else x for x in args)
        if self.training:
            return self.forward(*inputs)
        if not settings.detach_test_caches.on():
            raise NotImplementedError(
                "detach_test_caches(False), a prediction differentiated through its caches, is not ported"
            )
        with torch.no_grad():
            strategy = self.prediction_strategy()
        full_inputs = tuple(join_rows(ti, x) for ti, x in zip(self.train_inputs, inputs))
        full_output = self.forward(*full_inputs)
        with settings.cg_tolerance(settings.eval_cg_tolerance.value()):
            pred_mean, pred_covar = strategy.exact_prediction(full_output.loc, full_output.lazy_covariance_matrix)
        return MultivariateNormal(pred_mean, pred_covar)
