"""Delta — the point mass at v.  Counterpart of ``gpytorch_tpu/distributions/delta.py``: the
q(u) of ``DeltaVariationalDistribution`` (MAP inducing values)."""

from __future__ import annotations

from typing import Sequence

import torch


class Delta:
    def __init__(self, v: torch.Tensor, event_dim: int = 1):
        self.v = v
        self.event_dim = int(event_dim)

    @property
    def mean(self) -> torch.Tensor:
        return self.v

    @property
    def variance(self) -> torch.Tensor:
        return torch.zeros_like(self.v)

    @property
    def batch_shape(self) -> torch.Size:
        return self.v.shape[: self.v.ndim - self.event_dim]

    @property
    def event_shape(self) -> torch.Size:
        return self.v.shape[self.v.ndim - self.event_dim:]

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """0 where ``value`` is v (over the event dimensions), −∞ elsewhere."""
        eq = value == self.v
        if self.event_dim:
            eq = eq.flatten(-self.event_dim).all(-1)
        return torch.where(eq, 0.0, -torch.inf).to(self.v.dtype)

    def rsample(self, sample_shape: Sequence[int] = ()) -> torch.Tensor:
        return self.v.expand(tuple(sample_shape) + self.v.shape)
