"""MultitaskMultivariateNormal — a multivariate normal over (n × t) outputs.

Counterpart of ``gpytorch_tpu/distributions/multitask_multivariate_normal.py``.  The mean
is given as (..., n, t); the distribution itself lives on the flattened n·t event, in the
interleaved layout (index i·t + task, task fastest: the layout of K_data ⊗ K_task) or the
block layout (index task·n + i).  ``mean``, ``variance`` and ``log_prob`` read and take
(..., n, t) tensors in either layout.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..linop import BlockInterleavedLinearOperator, DenseLinearOperator
from .multivariate_normal import MultivariateNormal


class MultitaskMultivariateNormal(MultivariateNormal):
    def __init__(self, mean: torch.Tensor, covariance_matrix, interleaved: bool = True):
        if mean.ndim < 2:
            raise ValueError("MultitaskMultivariateNormal mean must be (..., n, t)")
        self._output_shape = tuple(mean.shape)
        self.interleaved = bool(interleaved)
        super().__init__(self._task_to_flat(mean), covariance_matrix)

    @property
    def num_tasks(self) -> int:
        return self._output_shape[-1]

    @property
    def event_shape(self) -> torch.Size:
        return torch.Size(self._output_shape[-2:])

    def _flat_to_task(self, flat: torch.Tensor) -> torch.Tensor:
        """(..., n·t) in this distribution's layout → (..., n, t)."""
        n, t = self._output_shape[-2:]
        if self.interleaved:
            return flat.reshape(flat.shape[:-1] + (n, t))
        return flat.reshape(flat.shape[:-1] + (t, n)).mT

    def _task_to_flat(self, arr: torch.Tensor) -> torch.Tensor:
        """(..., n, t) → (..., n·t) in this distribution's layout."""
        if self.interleaved:
            return arr.reshape(arr.shape[:-2] + (-1,))
        return arr.mT.reshape(arr.shape[:-2] + (-1,))

    @property
    def mean(self) -> torch.Tensor:
        return self._flat_to_task(super().mean)

    @property
    def variance(self) -> torch.Tensor:
        return self._flat_to_task(super().variance)

    def log_prob(self, value: torch.Tensor, base_samples=None, solver_state=None, return_state: bool = False):
        """log N(value; μ, K) for value of shape (..., n, t)."""
        return super().log_prob(self._task_to_flat(value), base_samples=base_samples, solver_state=solver_state,
                                return_state=return_state)

    def rsample(self, sample_shape: Sequence[int] = (), base_samples=None) -> torch.Tensor:
        """A joint draw over all n·t outputs, from the root decomposition of the whole
        covariance, of shape ``sample_shape`` + batch + (n, t)."""
        return self._flat_to_task(super().rsample(sample_shape, base_samples))

    def expand(self, batch_shape: Sequence[int]) -> "MultitaskMultivariateNormal":
        flat = MultivariateNormal(self.loc, self._covar).expand(batch_shape)
        new = object.__new__(type(self))
        new.loc, new._covar, new.interleaved = flat.loc, flat._covar, self.interleaved
        new._output_shape = tuple(batch_shape) + self._output_shape[-2:]
        return new

    @classmethod
    def from_batch_mvn(cls, batch_mvn: MultivariateNormal, task_dim: int = -1) -> "MultitaskMultivariateNormal":
        """Reads one batch dimension of ``batch_mvn`` (the last by default) as the tasks:
        a batch of t independent GPs becomes one distribution over (n, t), interleaved."""
        nd = len(batch_mvn.batch_shape)
        if task_dim not in (-1, nd - 1):
            task_dim = task_dim % nd
            mean = batch_mvn.mean.movedim(task_dim, -2)
            covar = DenseLinearOperator(batch_mvn.covariance_matrix.movedim(task_dim, -3))
        else:
            mean, covar = batch_mvn.mean, batch_mvn.lazy_covariance_matrix
        return cls(mean.mT, BlockInterleavedLinearOperator(covar), interleaved=True)

    @classmethod
    def from_independent_mvns(cls, mvns: Sequence[MultivariateNormal]) -> "MultitaskMultivariateNormal":
        """Independent MVNs over the same n points as the tasks, interleaved."""
        means = torch.stack([m.mean for m in mvns], dim=-1)  # (..., n, t)
        covars = torch.stack([m.covariance_matrix for m in mvns], dim=-3)  # (..., t, n, n)
        return cls(means, BlockInterleavedLinearOperator(DenseLinearOperator(covars)), interleaved=True)

    @classmethod
    def from_repeated_mvn(cls, mvn: MultivariateNormal, num_tasks: int) -> "MultitaskMultivariateNormal":
        return cls.from_independent_mvns([mvn] * num_tasks)
