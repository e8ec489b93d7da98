"""Multitask outputs of a batched variational strategy.  Counterpart of
``gpytorch_tpu/variational/multitask_variational_strategies.py``.

``IndependentMultitaskVariationalStrategy`` reads one batch dimension of the wrapped
strategy's q(f) (``task_dim``) as t independent tasks.  ``LMCVariationalStrategy`` (the linear
model of coregionalisation) mixes q latent GPs, a batch dimension of the wrapped strategy
(``latent_dim``), into t tasks by the coefficients W (q × t, a parameter):

    μ_task(x_i)_s = Σ_k W_ks μ_k(x_i),   Cov(f_s(x_i), f_s'(x_j)) = Σ_k W_ks W_ks' Σ_k(x_i, x_j),

formed densely over the interleaved n·t outputs, plus the wrapped strategy's jitter on the
diagonal.  Both take ``task_indices`` (one task a point, the Hadamard case): q(f) is then
the n outputs of those tasks.  The KL is the sum of the wrapped strategy's over its batch.

W starts as a standard-normal draw in float64 from ``generator`` (by default a CPU generator
seeded with 0), cast to the inducing points' dtype; the JAX package draws it from
``PRNGKey(0)``: carry its ``lmc_coefficients`` with ``load_jax_params`` to compare the two.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.module import Module
from ..distributions import MultitaskMultivariateNormal, MultivariateNormal
from ..linop import DenseLinearOperator


def _task_onehot(task_indices, num_tasks: int, like: torch.Tensor) -> tuple:
    """(indices (…, n) as integers, their one-hot rows (…, n, t) in ``like``'s dtype)."""
    ti = torch.as_tensor(task_indices, device=like.device).long()
    return ti, torch.nn.functional.one_hot(ti, num_tasks).to(like.dtype)


class IndependentMultitaskVariationalStrategy(Module):
    def __init__(self, base_variational_strategy, num_tasks: int, task_dim: int = -1):
        super().__init__()
        self.base_variational_strategy = base_variational_strategy
        self.num_tasks = int(num_tasks)
        self.task_dim = int(task_dim)

    @property
    def prior_distribution(self):
        return self.base_variational_strategy.prior_distribution

    def kl_divergence(self, model=None) -> torch.Tensor:
        return self.base_variational_strategy.kl_divergence(model=model).sum()

    def __call__(self, x, prior: bool = False, task_indices=None, model=None, **kwargs):
        function_dist = self.base_variational_strategy(x, prior=prior, model=model, **kwargs)
        if task_indices is None:
            return MultitaskMultivariateNormal.from_batch_mvn(function_dist, task_dim=self.task_dim)
        # one task a point: the mean of that task, the covariance within each task
        mean, covar = function_dist.mean, function_dist.covariance_matrix  # (…, t, n), (…, t, n, n)
        ti, onehot = _task_onehot(task_indices, self.num_tasks, mean)
        mean_sel = torch.take_along_dim(mean.movedim(-2, -1), ti.unsqueeze(-1), dim=-1).squeeze(-1)
        cov_sel = torch.einsum("...tij,it,jt->...ij", covar, onehot, onehot)
        return MultivariateNormal(mean_sel, DenseLinearOperator(cov_sel))


class LMCVariationalStrategy(Module):
    def __init__(self, base_variational_strategy, num_tasks: int, num_latents: int = 1, latent_dim: int = -1,
                 jitter_val: Optional[float] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.base_variational_strategy = base_variational_strategy
        self.num_tasks = int(num_tasks)
        self.num_latents = int(num_latents)
        if latent_dim >= 0:
            raise RuntimeError(f"latent_dim must be negative, got {latent_dim}")
        self.latent_dim = int(latent_dim)
        Z = base_variational_strategy.inducing_points
        batch_shape = tuple(base_variational_strategy._variational_distribution.batch_shape)
        # the coefficients' batch: the wrapped strategy's without the latent dimension
        lmc_batch = tuple(s for i, s in enumerate(batch_shape) if i - len(batch_shape) != self.latent_dim)
        generator = torch.Generator().manual_seed(0) if generator is None else generator
        coefficients = torch.randn(lmc_batch + (self.num_latents, self.num_tasks), generator=generator,
                                   dtype=torch.float64, device=generator.device)
        self.register_parameter("lmc_coefficients",
                                torch.nn.Parameter(coefficients.to(dtype=Z.dtype, device=Z.device)))

    @property
    def prior_distribution(self):
        return self.base_variational_strategy.prior_distribution

    def kl_divergence(self, model=None) -> torch.Tensor:
        return self.base_variational_strategy.kl_divergence(model=model).sum()

    def __call__(self, x, prior: bool = False, task_indices=None, model=None, **kwargs):
        latent_dist = self.base_variational_strategy(x, prior=prior, model=model, **kwargs)
        latent_dim = len(latent_dist.batch_shape) + self.latent_dim
        mean = latent_dist.mean.movedim(latent_dim, -2)  # (…, q, n)
        covar = latent_dist.covariance_matrix.movedim(latent_dim, -3)  # (…, q, n, n)
        W = self.lmc_coefficients  # (…, q, t)
        n, t = mean.shape[-1], self.num_tasks
        task_mean = torch.einsum("...qn,...qt->...nt", mean, W)
        big = torch.einsum("...qij,...qt,...qs->...itjs", covar, W, W)
        eye = torch.eye(n * t, dtype=big.dtype, device=big.device)
        task_covar = big.reshape(big.shape[:-4] + (n * t, n * t)) + self.base_variational_strategy.jitter_val * eye
        if task_indices is None:
            return MultitaskMultivariateNormal(task_mean, DenseLinearOperator(task_covar), interleaved=True)
        ti, onehot = _task_onehot(task_indices, t, task_mean)
        sel_mean = torch.take_along_dim(task_mean, ti.unsqueeze(-1), dim=-1).squeeze(-1)
        sel_cov = torch.einsum("...itjs,it,js->...ij", task_covar.reshape(task_covar.shape[:-2] + (n, t, n, t)),
                               onehot, onehot)
        return MultivariateNormal(sel_mean, DenseLinearOperator(sel_cov))
