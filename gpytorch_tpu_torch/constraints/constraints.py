"""Parameter constraints: raw → constrained maps and back.

Counterpart of ``gpytorch_tpu/constraints/constraints.py``.  A module stores each
constrained parameter raw (``raw_lengthscale``, ``raw_noise`` …) and reads it through the
constraint's ``transform``; setting a constrained value goes through ``inverse_transform``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def inv_softplus(x: torch.Tensor) -> torch.Tensor:
    """The inverse of softplus: softplus(y) = x ⇔ y = x + log(1 − e⁻ˣ)."""
    return x + torch.log(-torch.expm1(-x))


class GreaterThan:
    """value = lower_bound + softplus(raw)."""

    def __init__(self, lower_bound: float):
        self.lower_bound = float(lower_bound)

    def transform(self, raw: torch.Tensor) -> torch.Tensor:
        return self.lower_bound + F.softplus(raw)

    def inverse_transform(self, value: torch.Tensor) -> torch.Tensor:
        return inv_softplus(value - self.lower_bound)

    def check(self, value: torch.Tensor) -> bool:
        return bool((value > self.lower_bound).all())

    def __repr__(self):
        return f"{type(self).__name__}({self.lower_bound:.3E})"


class Positive(GreaterThan):
    """value = softplus(raw)."""

    def __init__(self):
        super().__init__(0.0)

    def transform(self, raw: torch.Tensor) -> torch.Tensor:
        return F.softplus(raw)

    def inverse_transform(self, value: torch.Tensor) -> torch.Tensor:
        return inv_softplus(value)


class Interval:
    """value = lower + (upper − lower)·sigmoid(raw)."""

    def __init__(self, lower_bound: float, upper_bound: float):
        self.lower_bound, self.upper_bound = float(lower_bound), float(upper_bound)

    def transform(self, raw: torch.Tensor) -> torch.Tensor:
        return self.lower_bound + (self.upper_bound - self.lower_bound) * torch.sigmoid(raw)

    def inverse_transform(self, value: torch.Tensor) -> torch.Tensor:
        return torch.logit((value - self.lower_bound) / (self.upper_bound - self.lower_bound))

    def check(self, value: torch.Tensor) -> bool:
        return bool(((value > self.lower_bound) & (value < self.upper_bound)).all())

    def __repr__(self):
        return f"{type(self).__name__}({self.lower_bound:.3E}, {self.upper_bound:.3E})"


class LessThan(Interval):
    """value = upper − softplus(−raw), unbounded below; the upper bound is the first
    argument (``gpytorch_tpu/constraints/constraints.py:91``)."""

    def __init__(self, upper_bound: float = math.inf):
        super().__init__(-math.inf, upper_bound)

    def transform(self, raw: torch.Tensor) -> torch.Tensor:
        return self.upper_bound - F.softplus(-raw)

    def inverse_transform(self, value: torch.Tensor) -> torch.Tensor:
        return -inv_softplus(self.upper_bound - value)

    def intersect(self, other) -> Interval:
        """The tighter bounds of the two: a ``LessThan`` while unbounded below, else an
        ``Interval`` (``gpytorch_tpu/constraints/constraints.py:97-103``)."""
        lower = max(self.lower_bound, other.lower_bound)
        upper = min(self.upper_bound, getattr(other, "upper_bound", math.inf))
        return LessThan(upper) if lower == -math.inf else Interval(lower, upper)
