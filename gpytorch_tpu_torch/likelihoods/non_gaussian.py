"""Non-Gaussian likelihoods.  Counterpart of ``gpytorch_tpu/likelihoods/non_gaussian.py``.

Each ``forward`` maps function values to a ``torch.distributions`` distribution (made
without argument validation, which would read the device at every call):

* ``BernoulliLikelihood``: probit classification, p(y = 1 | f) = Φ(f) with labels in {0, 1};
  its marginal Φ(μ / √(1 + σ²)) and log marginal are closed forms, and its expected log
  likelihood is the quadrature of log Φ((2y − 1) f);
* ``BetaLikelihood``: Beta(σ(f)·s, (1 − σ(f))·s) with a learned scale s;
* ``LaplaceLikelihood`` and ``StudentTLikelihood``: location f, scale √noise (Student-t with
  learned degrees of freedom > 2, initially 7);
* ``PoissonLikelihood``: rate softplus(f);
* ``NegativeBinomialLikelihood``: mean softplus(f), a learned success probability;
* ``SoftmaxLikelihood``: multiclass, the latent functions (optionally mixed by learned
  weights) as the logits of a ``Categorical``; its expectations are Monte Carlo
  (``Likelihood``).

The one-dimensional ones take their expectations under q(f) by Gauss–Hermite quadrature
(``_OneDimensionalLikelihood``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributions as td
import torch.nn.functional as F

from ..constraints import GreaterThan, Interval, Positive
from ..distributions import MultivariateNormal
from .likelihood import Likelihood, _OneDimensionalLikelihood


class BernoulliLikelihood(_OneDimensionalLikelihood):
    def forward(self, function_samples, *params):
        return td.Bernoulli(probs=torch.special.ndtr(function_samples), validate_args=False)

    @staticmethod
    def _z(function_dist: MultivariateNormal) -> torch.Tensor:
        return function_dist.mean / torch.sqrt(1.0 + function_dist.variance)

    def marginal(self, function_dist: MultivariateNormal, *params, **kwargs):
        return td.Bernoulli(probs=torch.special.ndtr(self._z(function_dist)), validate_args=False)

    def log_marginal(self, observations, function_dist: MultivariateNormal, *params, **kwargs):
        return torch.special.log_ndtr((observations * 2.0 - 1.0) * self._z(function_dist))

    def expected_log_prob(self, observations, function_dist: MultivariateNormal, *params, **kwargs):
        signs = observations * 2.0 - 1.0
        return self.quadrature(lambda f: torch.special.log_ndtr(f * signs), function_dist)


class _ConstrainedLikelihood(_OneDimensionalLikelihood):
    """A one-dimensional likelihood with raw parameters of shape batch + (1,), each behind
    a constraint and optionally scored by a prior."""

    def __init__(self, batch_shape=()):
        super().__init__()
        self.batch_shape = tuple(int(b) for b in batch_shape)

    def _register(self, name: str, init: float, constraint, prior) -> None:
        raw = f"raw_{name}"
        self.register_parameter(raw, torch.nn.Parameter(torch.full(self.batch_shape + (1,), float(init))))
        self.register_constraint(raw, constraint)
        if prior is not None:
            self.register_prior(f"{name}_prior", prior, lambda m: getattr(m, name),
                                lambda m, v: m._set_constrained(raw, v))


class BetaLikelihood(_ConstrainedLikelihood):
    def __init__(self, batch_shape=(), scale_prior=None, scale_constraint=None):
        super().__init__(batch_shape)
        self._register("scale", 1.0, scale_constraint or Positive(), scale_prior)

    @property
    def scale(self) -> torch.Tensor:
        return self._constrained("raw_scale")

    def forward(self, function_samples, *params):
        alpha = torch.sigmoid(function_samples) * self.scale + 1e-10
        return td.Beta(alpha, self.scale - alpha + 2e-10, validate_args=False)


class LaplaceLikelihood(_ConstrainedLikelihood):
    def __init__(self, batch_shape=(), noise_prior=None, noise_constraint=None):
        super().__init__(batch_shape)
        self._register("noise", 0.0, noise_constraint or Positive(), noise_prior)

    @property
    def noise(self) -> torch.Tensor:
        return self._constrained("raw_noise")

    def forward(self, function_samples, *params):
        return td.Laplace(function_samples, self.noise.sqrt(), validate_args=False)


class StudentTLikelihood(_ConstrainedLikelihood):
    def __init__(self, batch_shape=(), deg_free_prior=None, deg_free_constraint=None, noise_prior=None,
                 noise_constraint=None):
        super().__init__(batch_shape)
        self._register("deg_free", 0.0, deg_free_constraint or GreaterThan(2.0), deg_free_prior)
        self._register("noise", 0.0, noise_constraint or Positive(), noise_prior)
        self._set_constrained("raw_deg_free", 7.0)

    @property
    def deg_free(self) -> torch.Tensor:
        return self._constrained("raw_deg_free")

    @property
    def noise(self) -> torch.Tensor:
        return self._constrained("raw_noise")

    def forward(self, function_samples, *params):
        return td.StudentT(self.deg_free, function_samples, self.noise.sqrt(), validate_args=False)


class PoissonLikelihood(_OneDimensionalLikelihood):
    def forward(self, function_samples, *params):
        return td.Poisson(F.softplus(function_samples), validate_args=False)


class NegativeBinomialLikelihood(_ConstrainedLikelihood):
    def __init__(self, batch_shape=(), probs_prior=None, probs_constraint=None):
        super().__init__(batch_shape)
        self._register("probs", 0.0, probs_constraint or Interval(0.0, 1.0), probs_prior)

    @property
    def probs(self) -> torch.Tensor:
        return self._constrained("raw_probs")

    def forward(self, function_samples, *params):
        probs = self.probs.clamp(1e-6, 1 - 1e-6)
        total_count = F.softplus(function_samples) * (1 - probs) / probs
        return td.NegativeBinomial(total_count, probs=probs, validate_args=False)


class SoftmaxLikelihood(Likelihood):
    """``forward`` takes function values (..., num_features, n) or (..., n, num_features)
    and gives a ``Categorical`` over the classes at each of the n points; with
    ``mixing_weights`` its logits are the functions times a learned (num_classes,
    num_features) matrix, initially N(0, 1/num_features) draws from a CPU generator seeded
    with 0."""

    def __init__(self, num_features: Optional[int] = None, num_classes: Optional[int] = None,
                 mixing_weights: bool = True, mixing_weights_prior=None):
        super().__init__()
        if num_classes is None:
            raise ValueError("num_classes is required")
        self.num_classes = int(num_classes)
        self.has_mixing_weights = bool(mixing_weights)
        if mixing_weights:
            if num_features is None:
                raise ValueError("num_features is required with mixing weights")
            self.num_features = int(num_features)
            draws = torch.randn((self.num_classes, self.num_features), generator=torch.Generator().manual_seed(0),
                                dtype=torch.float64)
            self.register_parameter("mixing_weights",
                                    torch.nn.Parameter((draws / math.sqrt(num_features)).to(torch.float32)))
            if mixing_weights_prior is not None:
                self.register_prior("mixing_weights_prior", mixing_weights_prior, "mixing_weights")
        else:
            self.num_features = self.num_classes

    def forward(self, function_samples, *params):
        fs = function_samples
        if fs.ndim >= 2 and fs.shape[-2] == self.num_features:
            fs = fs.mT  # (..., n, num_features)
        logits = fs @ self.mixing_weights.to(fs.dtype).mT if self.has_mixing_weights else fs
        return td.Categorical(logits=logits, validate_args=False)
