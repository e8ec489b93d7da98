"""MultitaskGaussianLikelihood — noise over the tasks of a multitask GP.

Counterpart of ``gpytorch_tpu/likelihoods/multitask_gaussian_likelihood.py``.  The noise
covariance on the interleaved n·t event is I_n ⊗ Σ_task (+ σ²I with the global noise),
where Σ_task is diag(task noises) at ``rank`` 0 or F Fᵀ + 1e-4·I for a factor F of rank
``rank``; without task noise it is σ²I alone.  I_n ⊗ Σ_task + σ²I is a
``KroneckerProductAddedDiagLinearOperator``; the marginal adds it to the kernel's operator
as a sum with no preconditioner, as the JAX package does.  ``task_noise_covar_factor``
starts as a standard-normal draw from a ``torch.Generator`` seeded with 0: start two
packages alike with ``load_jax_params``.
"""

from __future__ import annotations

import math

import torch

from ..constraints import GreaterThan
from ..distributions import MultitaskMultivariateNormal
from ..linop import (ConstantDiagLinearOperator, DenseLinearOperator, DiagLinearOperator, IdentityLinearOperator,
                     KroneckerProductLinearOperator)
from .likelihood import Likelihood


class MultitaskGaussianLikelihood(Likelihood):
    def __init__(self, num_tasks: int, rank: int = 0, batch_shape=(), task_prior=None, noise_constraint=None,
                 has_global_noise: bool = True, has_task_noise: bool = True):
        super().__init__()
        if not (has_task_noise or has_global_noise):
            raise ValueError("At least one of has_task_noise or has_global_noise must be True")
        noise_constraint = noise_constraint or GreaterThan(1e-4)
        self.num_tasks, self.rank = int(num_tasks), int(rank)
        self.batch_shape = tuple(int(b) for b in batch_shape)
        self.has_global_noise, self.has_task_noise = bool(has_global_noise), bool(has_task_noise)
        if has_task_noise:
            if self.rank == 0:
                self.register_parameter("raw_task_noises", torch.nn.Parameter(torch.zeros(self.batch_shape + (num_tasks,))))
                self.register_constraint("raw_task_noises", noise_constraint)
            else:
                generator = torch.Generator().manual_seed(0)
                factor = torch.randn(self.batch_shape + (num_tasks, self.rank), generator=generator)
                self.register_parameter("task_noise_covar_factor", torch.nn.Parameter(factor))
                if task_prior is not None:
                    self.register_prior("MultitaskErrorCovariancePrior", task_prior, lambda m: m._eval_covar_matrix())
        if has_global_noise:
            self.register_parameter("raw_noise", torch.nn.Parameter(torch.zeros(self.batch_shape + (1,))))
            self.register_constraint("raw_noise", noise_constraint)

    @property
    def noise(self) -> torch.Tensor:
        return self._constrained("raw_noise")

    @noise.setter
    def noise(self, value) -> None:
        self._set_constrained("raw_noise", value)

    @property
    def task_noises(self) -> torch.Tensor:
        if self.rank != 0:
            raise RuntimeError("Cannot read task_noises when rank > 0")
        return self._constrained("raw_task_noises")

    @task_noises.setter
    def task_noises(self, value) -> None:
        self._set_constrained("raw_task_noises", value)

    def _eval_covar_matrix(self) -> torch.Tensor:
        cf = self.task_noise_covar_factor
        return cf @ cf.mT + 1e-4 * torch.eye(self.num_tasks, dtype=cf.dtype, device=cf.device)

    def _shaped_noise_covar(self, shape):
        """The noise covariance over the flattened interleaved event of ``shape[-1]`` = n·t."""
        n = shape[-1] // self.num_tasks
        if not self.has_task_noise:
            return ConstantDiagLinearOperator(self.noise, shape[-1])
        if self.rank == 0:
            task = DiagLinearOperator(self.task_noises)
        else:
            task = DenseLinearOperator(self._eval_covar_matrix())
        eye = IdentityLinearOperator(n, task.dtype, task.device, self.batch_shape)
        kron = KroneckerProductLinearOperator(eye, task)
        # I ⊗ Σ_task + σ²I stays a Kronecker-plus-constant operator (closed-form eigensolve)
        return kron.add_diagonal(self.noise) if self.has_global_noise else kron

    def marginal(self, function_dist: MultitaskMultivariateNormal, *params) -> MultitaskMultivariateNormal:
        """p(y | x): the kernel's covariance plus the noise covariance."""
        covar = function_dist.lazy_covariance_matrix + self._shaped_noise_covar(function_dist.loc.shape)
        return MultitaskMultivariateNormal(function_dist.mean, covar, interleaved=function_dist.interleaved)

    def _noise_diag(self, mean_shape) -> torch.Tensor:
        """The noise variances reshaped to (..., n, t)."""
        n, t = mean_shape[-2:]
        diag = self._shaped_noise_covar(tuple(mean_shape[:-2]) + (n * t,))._diagonal()
        return diag.reshape(diag.shape[:-1] + (n, t))

    def expected_log_prob(self, target: torch.Tensor, function_dist: MultitaskMultivariateNormal, *params):
        """E_f[log p(y | f)] at each point and task, in closed form."""
        mean, variance = function_dist.mean, function_dist.variance
        noise = self._noise_diag(mean.shape)
        return -0.5 * (((target - mean) ** 2 + variance) / noise + torch.log(noise) + math.log(2 * math.pi))

    def forward(self, function_samples: torch.Tensor, *params) -> torch.distributions.Normal:
        """p(y | f) for function values of shape (..., n, t)."""
        noise = self._noise_diag(function_samples.shape)
        return torch.distributions.Normal(function_samples, noise.expand(function_samples.shape).sqrt())
