"""Root operators.  Counterpart of ``gpytorch_tpu/linop/root.py``: ``RootLinearOperator``
A = R Rᵀ (the LOVE caches, and the posterior covariance that LOVE sampling draws from),
``LowRankRootLinearOperator``, the same operator tagged low-rank (SGPR's Nyström kernel
matrix, ``kernels/inducing_point_kernel.py``), and ``LowRankRootAddedDiagLinearOperator``
R Rᵀ + D (the pivoted-Cholesky preconditioner P, from which training draws its probe
vectors).

As in the JAX package, a low-rank root adds no algebra of its own: the likelihood's noise
makes it an ``AddedDiagLinearOperator``, whose solves and log-determinant take the dense
Cholesky factor up to ``settings.max_cholesky_size`` and preconditioned mBCG above it, the
products R(Rᵀv) and the rows R[idx] Rᵀ that the pivoted Cholesky reads going through
matrix products with the root (never the n × n matrix).

Samples are drawn from Gaussian base samples (``probe_base_samples``), never Rademacher
ones: the JAX package's ``rademacher_probes`` reaches user sampling through this module,
and the port does not copy that."""

from __future__ import annotations

import torch

from .base import LinearOperator, ProbeSource, _take_rows, probe_base_samples
from .diag import DiagLinearOperator


class RootLinearOperator(LinearOperator):
    """A = R Rᵀ for a (possibly rectangular) root tensor R of shape batch + (n, k)."""

    def __init__(self, root: torch.Tensor):
        self.root = root

    def _is_known_psd(self) -> bool:
        return True

    def _shape(self):
        n = self.root.shape[-2]
        return tuple(self.root.shape[:-2]) + (n, n)

    @property
    def dtype(self):
        return self.root.dtype

    @property
    def device(self):
        return self.root.device

    def _matmul(self, rhs):
        return self.root @ (self.root.mT @ rhs)

    def _flatten(self):
        return (self.root,), lambda ts: type(self)(ts[0])

    def _diagonal(self):
        return (self.root * self.root).sum(-1)

    def _get_rows(self, idx):
        return _take_rows(self.root, idx) @ self.root.mT

    def to_dense(self):
        return self.root @ self.root.mT

    def root_decomposition(self, method=None) -> "RootLinearOperator":
        return self

    def add_low_rank(self, new_root) -> "RootLinearOperator":
        """R Rᵀ + S Sᵀ as the root [R | S]."""
        new_root = new_root.to_dense() if isinstance(new_root, LinearOperator) else new_root
        return RootLinearOperator(torch.cat([self.root, new_root], dim=-1))

    def zero_mean_mvn_samples(self, num_samples: int, base_samples: ProbeSource = None) -> torch.Tensor:
        """(num_samples, *batch, n) draws R u of N(0, R Rᵀ), u of shape
        (num_samples, *batch, k, 1) from ``base_samples``."""
        shape = (num_samples,) + self.batch_shape + (self.root.shape[-1], 1)
        u = probe_base_samples(shape, self.dtype, self.device, base_samples)
        return (self.root @ u)[..., 0]


class LowRankRootLinearOperator(RootLinearOperator):
    """R Rᵀ for a root R (n, k) of rank k ≪ n: the algebra of ``RootLinearOperator``."""


class LowRankRootAddedDiagLinearOperator(LinearOperator):
    """R Rᵀ + D for a low-rank root R (n, k) and a diagonal D."""

    def __init__(self, low_rank: RootLinearOperator, diag_op: DiagLinearOperator):
        self.low_rank = low_rank
        self.diag_op = diag_op

    def _shape(self):
        return self.low_rank.shape

    @property
    def dtype(self):
        return self.low_rank.dtype

    @property
    def device(self):
        return self.low_rank.device

    def _matmul(self, rhs):
        return self.low_rank._matmul(rhs) + self.diag_op._matmul(rhs)

    def zero_mean_mvn_samples(self, num_samples: int, base_samples: ProbeSource = None) -> torch.Tensor:
        """(num_samples, *batch, n) draws of N(0, R Rᵀ + D): x = R u₁ + D^{1/2} u₂ with
        u ~ N(0, I), u₁ of shape (num_samples, *batch, k, 1) drawn first and u₂ of shape
        (num_samples, *batch, n), as the JAX package draws them."""
        R = self.low_rank.root
        batch, (n, k) = tuple(R.shape[:-2]), R.shape[-2:]
        u1 = probe_base_samples((num_samples,) + batch + (k, 1), R.dtype, R.device, base_samples)
        u2 = probe_base_samples((num_samples,) + batch + (n,), R.dtype, R.device, base_samples)
        return (R @ u1)[..., 0] + torch.sqrt(self.diag_op._diag_values()) * u2
