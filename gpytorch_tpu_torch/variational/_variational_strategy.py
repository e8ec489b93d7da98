"""Variational strategy base.  Counterpart of ``gpytorch_tpu/variational/_variational_strategy.py``.

A strategy holds the inducing points Z and q(u).  ``__call__`` initialises q(u) from the
prior p(u) on its first call (the buffer ``variational_params_initialized`` records that it
did), broadcasts Z and the inputs to one batch shape, and hands q(u) to the subclass's
``forward``, which returns q(f(x)).

The strategy belongs to its model, and its ``forward`` calls the model's ``forward``.  As
in the JAX package the model is passed at call time (``strategy(x, model=model)``, which
``ApproximateGP`` does); the reference kept at construction is stored outside
``nn.Module``'s registry, so that ``.modules()`` and ``.parameters()`` of the model do not
loop through its own strategy.

Online variational conditioning (Maddox et al. 2021, arXiv 2110.15172;
``gpytorch_tpu/variational/_variational_strategy.py:117-177``): ``pseudo_points`` (each
strategy's own) gives a Gaussian observation model over the inducing points, pseudo-targets
ỹ with a full noise covariance D̃, such that the exact GP conditioned on (Z, ỹ) has the
posterior q(f); ``amortized_exact_gp`` builds that exact GP, its likelihood the model's
(a ``GaussianLikelihood`` where the model has none) and its training covariance
K_ZZ + D̃, and ``get_fantasy_model`` conditions it on new observations (a Cholesky q(u)
only).  As in the JAX package, the fantasy's new training covariance takes the
likelihood's noise on every point: the variances of a fantasy read K_ZZ + σ²I where its
mean reads K_ZZ + D̃.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import settings
from ..core.module import Module
from ..distributions import Delta, MultivariateNormal, kl_divergence
from ..linop import to_linear_operator


class _VariationalStrategy(Module):
    def __init__(self, model, inducing_points: torch.Tensor, variational_distribution,
                 learn_inducing_locations: bool = True, jitter_val: Optional[float] = None):
        super().__init__()
        object.__setattr__(self, "_model_ref", model)
        inducing_points = inducing_points.detach().clone()
        if inducing_points.ndim == 1:
            inducing_points = inducing_points.unsqueeze(-1)
        if learn_inducing_locations:
            self.register_parameter("inducing_points", torch.nn.Parameter(inducing_points))
        else:
            self.register_buffer("inducing_points", inducing_points)
        self.learn_inducing_locations = bool(learn_inducing_locations)
        self._variational_distribution = variational_distribution
        self.register_buffer("variational_params_initialized", torch.zeros((), dtype=torch.int32))
        self._jitter_val = jitter_val

    @property
    def jitter_val(self) -> float:
        if self._jitter_val is None:
            return settings.variational_cholesky_jitter.value(self.inducing_points.dtype)
        return self._jitter_val

    def _resolve_model(self, model):
        model = self._model_ref if model is None else model
        if model is None:
            raise RuntimeError("a variational strategy needs its model (pass model=...)")
        return model

    @property
    def variational_distribution(self):
        """q(u), as the variational distribution's ``forward`` returns it."""
        return self._variational_distribution()

    def prior_distribution(self, model=None) -> MultivariateNormal:
        raise NotImplementedError

    def kl_divergence(self, model=None) -> torch.Tensor:
        """KL(q(u) ‖ p(u)), one value per batch element; for a Delta q(u), −log p(m)."""
        q_u = self.variational_distribution
        prior = self.prior_distribution(model)
        if isinstance(q_u, Delta):
            return -prior.log_prob(q_u.v)
        return kl_divergence(q_u, prior)

    def forward(self, x, inducing_points, inducing_values, variational_inducing_covar=None, model=None, **kwargs):
        raise NotImplementedError

    def _maybe_initialize(self, model) -> None:
        if int(self.variational_params_initialized) == 0:
            with torch.no_grad():
                self._variational_distribution.initialize_variational_distribution(self.prior_distribution(model))
            self.variational_params_initialized.fill_(1)

    def __call__(self, x: torch.Tensor, prior: bool = False, model=None, **kwargs):
        model = self._resolve_model(model)
        if prior:
            return model.forward(x)
        self._maybe_initialize(model)
        if x.ndim == 1:
            x = x.unsqueeze(-1)
        inducing_points = self.inducing_points
        if inducing_points.shape[:-2] != x.shape[:-2]:
            batch = torch.broadcast_shapes(inducing_points.shape[:-2], x.shape[:-2])
            inducing_points = inducing_points.expand(batch + inducing_points.shape[-2:])
            x = x.expand(batch + x.shape[-2:])
        q_u = self.variational_distribution
        if isinstance(q_u, MultivariateNormal):
            return self.forward(x, inducing_points, q_u.loc, q_u.lazy_covariance_matrix, model=model, **kwargs)
        if isinstance(q_u, Delta):
            return self.forward(x, inducing_points, q_u.v, None, model=model, **kwargs)
        raise RuntimeError(f"invalid variational distribution type {type(q_u).__name__}")

    # -- online variational conditioning ---------------------------------------------------
    def pseudo_points(self, model=None):
        """(D̃, ỹ − μ_Z as a column): the pseudo-observations' noise covariance and centred
        targets, of each strategy."""
        raise NotImplementedError("Each variational strategy must implement its own pseudo points method")

    def amortized_exact_gp(self, model=None, mean_module=None, covar_module=None):
        """The exact GP over the pseudo-observations, in eval mode, with its prediction
        strategy built on K_ZZ + D̃ (the model's mean and kernel unless given)."""
        from ..likelihoods.gaussian_likelihood import GaussianLikelihood
        from ..models.exact_gp import ExactGP
        from ..models.exact_prediction_strategies import DefaultPredictionStrategy

        model = self._resolve_model(model)
        mean_module = model.mean_module if mean_module is None else mean_module
        covar_module = model.covar_module if covar_module is None else covar_module
        pseudo_covar, pseudo_mean = self.pseudo_points(model)
        Z = self.inducing_points.detach()
        pseudo_y = pseudo_mean[..., 0] + mean_module(Z)

        class _PseudoExactGP(ExactGP):
            def __init__(self, likelihood):
                super().__init__(Z, pseudo_y, likelihood)
                self.mean_module, self.covar_module = mean_module, covar_module

            def forward(self, x):
                return MultivariateNormal(self.mean_module(x), self.covar_module(x))

        likelihood = model.likelihood if hasattr(model, "likelihood") else GaussianLikelihood().to(Z)
        exact = _PseudoExactGP(likelihood).eval()
        prior = exact.forward(Z)
        strategy = DefaultPredictionStrategy((Z,), prior, pseudo_y, likelihood)
        strategy.lik_train_train_covar = (prior.lazy_covariance_matrix.evaluate_kernel()
                                          + to_linear_operator(pseudo_covar)).evaluate_kernel()
        exact._cache["prediction_strategy"] = strategy
        return exact

    def get_fantasy_model(self, inputs, targets, model=None, mean_module=None, covar_module=None, **kwargs):
        """The amortized exact GP conditioned on (``inputs``, ``targets``) by its fantasy
        update (``ExactGP.get_fantasy_model``)."""
        from ._variational_distribution import CholeskyVariationalDistribution

        if not isinstance(self._variational_distribution, CholeskyVariationalDistribution):
            raise NotImplementedError("Fantasy models are only supported for CholeskyVariationalDistribution")
        exact = self.amortized_exact_gp(model=model, mean_module=mean_module, covar_module=covar_module)
        return exact.get_fantasy_model(inputs, targets, **kwargs)
