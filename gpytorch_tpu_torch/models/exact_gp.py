"""ExactGP — exact Gaussian-process regression.

Counterpart of ``gpytorch_tpu/models/exact_gp.py``.  ``__call__`` returns the prior
``forward`` in prior mode (``settings.prior_mode``, or a model without training data) and
in training mode; in eval mode it returns the posterior over the test inputs, from a
prediction strategy cached until ``clear_caches()``, ``train()``, ``eval()`` or
``set_train_data``.  The joint train/test prior is formed lazily and only its test rows
are ever evaluated.  ``get_fantasy_model`` conditions a copy of the model on new
observations by a rank-m update of the cached strategy.

Under the default ``detach_test_caches`` the strategy and its caches are built without
gradients: the posterior is differentiable with respect to the test inputs, and with
respect to the hyperparameters through its test side (K**, K*x and μ*).  Serving callers
wrap their requests in ``torch.no_grad()``.  Under ``detach_test_caches(False)`` with
autograd on, each call (and each ``get_fantasy_model``) builds or takes a strategy whose
caches carry their autograd history, and uses it once, so that a prediction is
differentiable through its caches too (the hyperparameters through K⁻¹(y − μ), and a
fantasy model's inputs through its Schur update).

A batched model (a batched kernel, mean and likelihood on inputs of shape batch + (n, d) or
shared (n, d) inputs, targets batch + (n,)) trains and predicts every element at once.  A
multitask model (its ``forward`` a ``MultitaskMultivariateNormal``) takes targets of shape
(n, t), flattened to the distribution's layout, and predicts a
``MultitaskMultivariateNormal``.  Fantasy models of either condition on new points too
(a Schur update per batch element; the caches of a multitask one rebuilt on the joint
operator).
"""

from __future__ import annotations

import copy
import warnings
from typing import Optional

import torch

from .. import settings
from ..distributions import MultitaskMultivariateNormal, MultivariateNormal
from ..linop import join_rows
from ..utils.warnings import GPInputWarning
from .gp import GP
from .exact_prediction_strategies import prediction_strategy as _prediction_strategy


def _as_inputs(inputs) -> tuple:
    if torch.is_tensor(inputs):
        inputs = (inputs,)
    return tuple(x.unsqueeze(-1) if x.ndim == 1 else x for x in inputs)


class ExactGP(GP):
    """Subclasses define ``forward(x) -> MultivariateNormal`` (the prior).

    ``lanczos_init`` optionally fixes the start block (n, b) of the LOVE Lanczos run;
    by default it is drawn from a CPU generator seeded with 0."""

    def __init__(self, train_inputs, train_targets, likelihood, lanczos_init: Optional[torch.Tensor] = None):
        super().__init__()
        if train_inputs is None and train_targets is not None:
            raise RuntimeError("train_targets without train_inputs")
        self.train_inputs = None if train_inputs is None else _as_inputs(train_inputs)
        self.train_targets = train_targets
        self.likelihood = likelihood
        self.lanczos_init = lanczos_init

    def forward(self, *inputs) -> MultivariateNormal:
        raise NotImplementedError

    def set_train_data(self, inputs=None, targets=None, strict: bool = True) -> None:
        """Replace the training inputs and/or targets and clear the caches.  With
        ``strict`` their shapes and dtypes must stay as they were.  A ``lanczos_init``
        whose rows no longer match the training inputs is dropped."""
        if inputs is not None:
            inputs = _as_inputs(inputs)
            if strict and self.train_inputs is not None:
                for old, new in zip(self.train_inputs, inputs):
                    if old.shape != new.shape or old.dtype != new.dtype:
                        raise RuntimeError("Cannot modify shape/dtype of train inputs under strict=True")
            self.train_inputs = inputs
            if self.lanczos_init is not None and self.lanczos_init.shape[0] != inputs[0].shape[-2]:
                self.lanczos_init = None
        if targets is not None:
            if strict and self.train_targets is not None:
                if targets.shape != self.train_targets.shape or targets.dtype != self.train_targets.dtype:
                    raise RuntimeError("Cannot modify shape/dtype of train targets under strict=True")
            self.train_targets = targets
        self.clear_caches()

    def _build_strategy(self):
        train_prior_dist = self.forward(*self.train_inputs)
        return _prediction_strategy(self.train_inputs, train_prior_dist, self.train_targets, self.likelihood,
                                    self.lanczos_init)

    def prediction_strategy(self):
        """The cached prediction strategy without autograd history (built at first use)."""
        strategy = self._cache.get("prediction_strategy")
        if strategy is not None and strategy.with_graph:
            strategy = strategy.detached()
        if strategy is None:
            with torch.no_grad():
                strategy = self._build_strategy()
        self._cache["prediction_strategy"] = strategy
        return strategy

    def _call_strategy(self):
        """The strategy of one call: ``prediction_strategy()``, or under
        ``detach_test_caches(False)`` with autograd on, the cached strategy with history if
        no call has used it yet, else a new one; the call uses it up."""
        if settings.detach_test_caches.on() or not torch.is_grad_enabled():
            return self.prediction_strategy()
        strategy = self._cache.get("prediction_strategy")
        if strategy is None or not strategy.with_graph or strategy.spent:
            strategy = self._build_strategy()
            self._cache["prediction_strategy"] = strategy
        strategy.spent = True
        return strategy

    def refresh(self):
        """Build the prediction caches now rather than at the first request
        (``build_caches``: the mean cache, one CG solve, and under ``fast_pred_var`` or
        ``fast_pred_samples`` the LOVE cache; a KISS-GP strategy's in inducing space).
        Returns the prediction strategy that holds them."""
        with torch.no_grad(), settings.cg_tolerance(settings.eval_cg_tolerance.value()):
            strategy = self.prediction_strategy()
            strategy.build_caches()
        return strategy

    def get_fantasy_model(self, inputs, targets, **kwargs) -> "ExactGP":
        """A copy of this model conditioned on the new observations (``inputs``,
        ``targets``) without refitting (``gpytorch_tpu/models/exact_gp.py:63-103``).  Its
        training inputs are the old ones and the new ones joined by ``join_rows`` on the
        data axis −2 (broadcast to a common batch shape), its targets joined on −1, or on
        −2 for a multitask model (its training prior a ``MultitaskMultivariateNormal``,
        targets (n, t)); its ``lanczos_init`` is None.  ``noise=`` (the new observations'
        noise, for a fixed-noise likelihood) makes the copy's likelihood
        ``likelihood.get_fantasy_likelihood(noise=...)``.  If this model holds a prediction
        strategy, the copy's comes from the strategy's update (``get_fantasy_strategy``: a
        rank-m Schur update per batch element, m solves against the old system at the
        ambient ``cg_tolerance``; for a multitask model caches built at first use on the
        joint operator); otherwise the copy builds its own at first use.  The copy's
        parameters are new tensors with the same values; under ``detach_test_caches(False)``
        its caches depend on this model's parameters as well, and its LOVE root is built at
        first use on the joint (n + m) operator with the new inputs' history.  A KISS-GP
        model's copy takes WISKI's update instead."""
        if self.train_inputs is None:
            raise RuntimeError("Cannot get a fantasy model without training data")
        fantasy_kwargs = {"noise": kwargs.pop("noise")} if "noise" in kwargs else {}
        if kwargs:
            raise TypeError(f"unexpected arguments {sorted(kwargs)}")
        if fantasy_kwargs and not hasattr(self.likelihood, "get_fantasy_likelihood"):
            raise RuntimeError("noise= needs a likelihood with get_fantasy_likelihood (a fixed-noise likelihood)")
        inputs = _as_inputs(inputs)
        full_inputs = tuple(join_rows(*_common_batch(ti, x)) for ti, x in zip(self.train_inputs, inputs))
        old_strategy = None
        if self._cache.get("prediction_strategy") is not None:
            old_strategy = self._call_strategy()
            train_prior = old_strategy.train_prior_dist
        else:
            with torch.no_grad():
                train_prior = self.forward(*self.train_inputs)
        data_axis = -2 if isinstance(train_prior, MultitaskMultivariateNormal) else -1
        full_targets = torch.cat([self.train_targets, targets], data_axis)
        # what is replaced below (and a history, which cannot be deep-copied) stays out of the copy
        held = {name: self.__dict__[name] for name in ("_cache", "train_inputs", "train_targets", "lanczos_init")}
        self.__dict__.update(_cache={}, train_inputs=None, train_targets=None, lanczos_init=None)
        try:
            new_model = copy.deepcopy(self)
        finally:
            self.__dict__.update(held)
        new_model.train_inputs, new_model.train_targets = full_inputs, full_targets
        if fantasy_kwargs:
            new_model.likelihood = self.likelihood.get_fantasy_likelihood(**fantasy_kwargs)
        if old_strategy is not None:
            with old_strategy._grad_mode():
                full_output = self.forward(*full_inputs)
            new_model._cache["prediction_strategy"] = old_strategy.get_fantasy_strategy(
                inputs, targets, full_inputs, full_targets, full_output, **fantasy_kwargs)
        return new_model

    def __call__(self, *args) -> MultivariateNormal:
        inputs = _as_inputs(args)
        if settings.prior_mode.on() or self.train_inputs is None or self.train_targets is None:
            return self.forward(*inputs)
        same_count = len(inputs) == len(self.train_inputs)
        if self.training:
            if settings.debug.on() and same_count and any(ti.shape != x.shape for ti, x in zip(self.train_inputs, inputs)):
                raise RuntimeError("You must train on the training inputs!")
            return self.forward(*inputs)
        # shapes first: a request of another shape never reads the device
        if (settings.debug.on() and same_count and all(ti.shape == x.shape for ti, x in zip(self.train_inputs, inputs))
                and all(ti is x or torch.equal(ti, x) for ti, x in zip(self.train_inputs, inputs))):
            warnings.warn("The input matches the stored training data. Did you forget to call model.train()?",
                          GPInputWarning)
        strategy = self._call_strategy()
        full_inputs = tuple(join_rows(*_common_batch(ti, x)) for ti, x in zip(self.train_inputs, inputs))
        full_output = self.forward(*full_inputs)
        with settings.cg_tolerance(settings.eval_cg_tolerance.value()):
            pred_mean, pred_covar = strategy.exact_prediction(full_output.loc, full_output.lazy_covariance_matrix)
        if isinstance(full_output, MultitaskMultivariateNormal):
            t = full_output.num_tasks
            flat_shape = pred_mean.shape[:-1] + (pred_mean.shape[-1] // t, t)
            task_mean = pred_mean.reshape(flat_shape) if full_output.interleaved else (
                pred_mean.reshape(flat_shape[:-2] + (t, -1)).mT)
            return MultitaskMultivariateNormal(task_mean, pred_covar, interleaved=full_output.interleaved)
        return MultivariateNormal(pred_mean, pred_covar)


def _common_batch(a: torch.Tensor, b: torch.Tensor):
    """a and b broadcast to their common batch shape (the training and the test inputs of a
    batched model); each unchanged where it has it already."""
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return tuple(x if x.shape[:-2] == batch else x.expand(batch + x.shape[-2:]) for x in (a, b))
