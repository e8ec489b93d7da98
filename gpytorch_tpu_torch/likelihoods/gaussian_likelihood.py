"""Gaussian likelihoods.  Counterpart of ``GaussianLikelihood``,
``GaussianLikelihoodWithMissingObs``, ``FixedNoiseGaussianLikelihood``,
``DirichletClassificationLikelihood`` and ``HadamardGaussianLikelihood`` in
``gpytorch_tpu/likelihoods/gaussian_likelihood.py``."""

from __future__ import annotations

import copy
import math
import warnings

import torch

from ..distributions import MultivariateNormal
from ..linop import DiagLinearOperator, ZeroLinearOperator
from ..utils.warnings import GPInputWarning
from .likelihood import Likelihood
from .noise_models import FixedGaussianNoise, HomoskedasticNoise, MultitaskHomoskedasticNoise


class _GaussianLikelihoodBase(Likelihood):
    """The likelihoods whose marginal adds a diagonal noise to the covariance, and whose
    expectations under a Gaussian q(f) are closed forms."""

    def __init__(self, noise_covar):
        super().__init__()
        self.noise_covar = noise_covar

    def _shaped_noise_covar(self, base_shape, *params, **kwargs):
        """The noise covariance over the points of ``base_shape``."""
        return self.noise_covar(*params, shape=base_shape, **kwargs)

    def _noise_diag(self, shape, *params) -> torch.Tensor:
        """σ² at every point of a tensor of ``shape``."""
        return self._shaped_noise_covar(shape, *params)._diagonal().expand(shape)

    def forward(self, function_samples: torch.Tensor, *params) -> torch.distributions.Normal:
        """p(y | f) = N(f, σ²) at every point."""
        noise = self._noise_diag(function_samples.shape, *params)
        return torch.distributions.Normal(function_samples, noise.sqrt(), validate_args=False)

    def expected_log_prob(self, target, function_dist: MultivariateNormal, *params, base_samples=None):
        """E_q[log p(y | f)] = −½[((y − μ)² + σ_f²)/σ² + log σ² + log 2π] per point."""
        mean, variance = function_dist.mean, function_dist.variance
        noise = self._noise_diag(mean.shape, *params)
        return -0.5 * (((target - mean) ** 2 + variance) / noise + torch.log(noise) + math.log(2 * math.pi))

    def log_marginal(self, observations, function_dist: MultivariateNormal, *params, base_samples=None):
        """log N(y; μ, σ_f² + σ²) per point."""
        return self.marginal(function_dist, *params).to_data_independent_dist().log_prob(observations)

    def marginal(self, function_dist: MultivariateNormal, *params, **kwargs) -> MultivariateNormal:
        """p(y | x) = N(μ, K + Σ_noise)."""
        mean = function_dist.loc
        return MultivariateNormal(mean, function_dist.lazy_covariance_matrix
                                  + self._shaped_noise_covar(mean.shape, *params, **kwargs))


class GaussianLikelihood(_GaussianLikelihoodBase):
    """Homoskedastic noise σ², one per batch element under ``batch_shape``."""

    def __init__(self, noise_prior=None, noise_constraint=None, batch_shape=()):
        super().__init__(HomoskedasticNoise(noise_prior, noise_constraint, batch_shape))

    @property
    def noise(self) -> torch.Tensor:
        return self.noise_covar.noise

    @noise.setter
    def noise(self, value) -> None:
        self.noise_covar.noise = value


class GaussianLikelihoodWithMissingObs(GaussianLikelihood):
    """A Gaussian likelihood whose pointwise log-densities skip missing (NaN) targets:
    ``log_marginal`` and ``expected_log_prob`` read 0 at them."""

    def log_marginal(self, observations, function_dist: MultivariateNormal, *params, base_samples=None):
        observed = ~torch.isnan(observations)
        lp = super().log_marginal(torch.where(observed, observations, torch.zeros_like(observations)),
                                  function_dist, *params)
        return torch.where(observed, lp, torch.zeros_like(lp))

    def expected_log_prob(self, target, function_dist: MultivariateNormal, *params, base_samples=None):
        observed = ~torch.isnan(target)
        res = super().expected_log_prob(torch.where(observed, target, torch.zeros_like(target)), function_dist, *params)
        return torch.where(observed, res, torch.zeros_like(res))


class FixedNoiseGaussianLikelihood(_GaussianLikelihoodBase):
    """A known noise per training point (``noise``, of shape batch + (n,)), and with
    ``learn_additional_noise`` a learned homoskedastic noise on top.  At points other than
    the training points (a request) the fixed part is the zero operator, with a
    ``GPInputWarning`` when no learned noise is there either: a no-noise prediction, unless
    the call gives ``noise=``."""

    def __init__(self, noise, learn_additional_noise: bool = False, batch_shape=()):
        super().__init__(FixedGaussianNoise(noise))
        self.second_noise_covar = HomoskedasticNoise(batch_shape=batch_shape) if learn_additional_noise else None

    @property
    def noise(self) -> torch.Tensor:
        noise = self.noise_covar.noise
        if self.second_noise_covar is not None:
            noise = noise + self.second_noise_covar.noise
        return noise

    @noise.setter
    def noise(self, value) -> None:
        self.noise_covar.noise = torch.as_tensor(value)

    @property
    def second_noise(self):
        return 0.0 if self.second_noise_covar is None else self.second_noise_covar.noise

    def get_fantasy_likelihood(self, **kwargs) -> "FixedNoiseGaussianLikelihood":
        """A copy whose fixed noise is the old one followed by the new observations'
        (``noise``, required), the old one broadcast to the new one's batch shape."""
        if "noise" not in kwargs:
            raise RuntimeError("FixedNoiseGaussianLikelihood.fantasize requires a `noise` kwarg")
        old = self.noise_covar.noise
        new_noise = torch.as_tensor(kwargs["noise"], dtype=old.dtype, device=old.device)
        if new_noise.ndim > old.ndim:
            old = old.expand(new_noise.shape[:-1] + old.shape[-1:])
        new = copy.deepcopy(self)
        new.noise_covar = FixedGaussianNoise(torch.cat([old, new_noise], -1))
        return new

    def _shaped_noise_covar(self, base_shape, *params, **kwargs):
        res = self.noise_covar(*params, shape=base_shape, **kwargs)
        if self.second_noise_covar is not None:
            res = res + self.second_noise_covar(*params, shape=base_shape)
        elif isinstance(res, ZeroLinearOperator):
            warnings.warn("You have passed data through a FixedNoiseGaussianLikelihood that did not match the size "
                          "of the fixed noise, *and* you did not specify noise. This is treated as a no-noise "
                          "prediction.", GPInputWarning)
        return res


class DirichletClassificationLikelihood(FixedNoiseGaussianLikelihood):
    """GP classification by Dirichlet regression on labels 0..C−1 of shape (n,): each class
    is a regression on log α − σ²/2 with fixed noise σ² = log(1/α + 1), α = ε + [label ==
    class], so that a batch of C independent GPs (batch shape (C,)) fits
    ``transformed_targets`` (C, n).  Its fantasy likelihood is itself: new points get no
    noise (the zero operator), as in the JAX package."""

    def __init__(self, targets, alpha_epsilon: float = 0.01, learn_additional_noise: bool = False, batch_shape=(),
                 dtype: torch.dtype = torch.float32):
        targets = torch.as_tensor(targets)
        sigma2, transformed, num_classes = self._prepare_targets(targets, alpha_epsilon, dtype)
        super().__init__(sigma2, learn_additional_noise=learn_additional_noise, batch_shape=batch_shape)
        self.register_buffer("transformed_targets", transformed)
        self.register_buffer("targets", targets)
        self.num_classes = num_classes
        self.alpha_epsilon = alpha_epsilon

    @staticmethod
    def _prepare_targets(targets: torch.Tensor, alpha_epsilon: float = 0.01, dtype: torch.dtype = torch.float32):
        """(σ², transformed targets, C): both (C, n), C = max label + 1 (read on the host)."""
        num_classes = int(targets.max()) + 1
        n = targets.shape[-1]
        alpha = torch.full((n, num_classes), alpha_epsilon, dtype=dtype, device=targets.device)
        alpha[torch.arange(n, device=targets.device), targets.long()] += 1.0
        sigma2 = torch.log(1.0 / alpha + 1.0)
        transformed = torch.log(alpha) - 0.5 * sigma2
        return sigma2.mT, transformed.mT, num_classes

    def get_fantasy_likelihood(self, **kwargs) -> "DirichletClassificationLikelihood":
        return self

    def __call__(self, input, *args, **kwargs):
        """With ``targets=``, the targets are prepared anew first (the fixed noise and
        ``transformed_targets`` replaced)."""
        if "targets" in kwargs:
            targets = torch.as_tensor(kwargs.pop("targets"))
            sigma2, transformed, _ = self._prepare_targets(targets, self.alpha_epsilon,
                                                           self.transformed_targets.dtype)
            self.transformed_targets = transformed
            self.targets = targets
            self.noise_covar = FixedGaussianNoise(sigma2)
        return super().__call__(input, *args, **kwargs)


class HadamardGaussianLikelihood(_GaussianLikelihoodBase):
    """One noise σ²_t per task, chosen at each point by its task index
    (``gpytorch_tpu/likelihoods/gaussian_likelihood.py:196-220``): the likelihood of a
    Hadamard multitask GP, whose points each carry one task.

    The task indices are the first positional argument after the distribution, read as
    the JAX package reads them: cast to integers, and column 0 of a 2-D argument.  A
    prediction strategy passes the training inputs there, so a model whose inputs hold the
    task in column 0 can be served."""

    def __init__(self, num_tasks: int, noise_prior=None, noise_constraint=None, batch_shape=()):
        super().__init__(MultitaskHomoskedasticNoise(num_tasks, noise_prior, noise_constraint, batch_shape))
        self.num_tasks = int(num_tasks)

    @property
    def task_noises(self) -> torch.Tensor:
        return self.noise_covar.noise

    def _task_indices(self, params) -> torch.Tensor:
        if not params:
            raise RuntimeError("HadamardGaussianLikelihood needs the task indices")
        idx = params[0].long()
        return idx[..., 0] if idx.ndim > 1 else idx

    def _noise_diag(self, shape, *params) -> torch.Tensor:
        noise = self.noise_covar.noise  # (*batch, num_tasks)
        idx = self._task_indices(params)
        return torch.take_along_dim(noise, idx.expand(noise.shape[:-1] + idx.shape[-1:]), dim=-1).expand(shape)

    def marginal(self, function_dist: MultivariateNormal, *params) -> MultivariateNormal:
        """p(y | x) = N(μ, K + diag(σ²_{task(i)}))."""
        point_noise = self._noise_diag(function_dist.loc.shape, *params)
        return MultivariateNormal(function_dist.loc, function_dist.lazy_covariance_matrix + DiagLinearOperator(point_noise))
