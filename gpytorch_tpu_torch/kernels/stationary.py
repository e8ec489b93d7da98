"""Stationary kernels with (ARD) lengthscales: RBF, Matérn and periodic.

Counterpart of ``RBFKernel``, ``MaternKernel`` and ``PeriodicKernel`` in
``gpytorch_tpu/kernels/stationary.py``.  Each maps onto its fused kernel product
(``ops/fused_kernels.py``, ``ops/periodic_kernels.py``) whenever K is too large to evaluate
densely.  With ``last_dim_is_batch`` each evaluates one matrix per input dimension,
(…, d, n, m), from the inputs scaled as usual (``_last_dim_batch``).
"""

from __future__ import annotations

import math

import torch

from ..constraints import Positive
from ..ops.fused_kernels import _kernel_fn, kernel_type_for
from .kernel import Kernel


def _last_dim_batch(x1, x2, last_dim_is_batch: bool):
    """(…, n, d) inputs as (…, d, n, 1) with ``last_dim_is_batch``: each dimension alone."""
    if last_dim_is_batch:
        return x1.mT.unsqueeze(-1), x2.mT.unsqueeze(-1)
    return x1, x2


class RBFKernel(Kernel):
    """k(x, x') = exp(−½‖(x−x')/ℓ‖²)."""

    has_lengthscale = True

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        ls = hypers["lengthscale"]
        x1, x2 = _last_dim_batch(x1 / ls, x2 / ls, last_dim_is_batch)
        return torch.exp(-0.5 * self.covar_dist(x1, x2, diag=diag))


class MaternKernel(Kernel):
    """Matérn with ν ∈ {0.5, 1.5, 2.5} of r = ‖(x−x')/ℓ‖: exp(−r), (1 + √3r)·exp(−√3r) or
    (1 + √5r + 5r²/3)·exp(−√5r), with r floored at √1e-30 as in the JAX package."""

    has_lengthscale = True

    def __init__(self, nu: float = 2.5, **kwargs):
        if nu not in (0.5, 1.5, 2.5):
            raise RuntimeError("nu must be one of 0.5, 1.5, 2.5")
        super().__init__(**kwargs)
        self.nu = nu

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        ls = hypers["lengthscale"]
        x1, x2 = _last_dim_batch(x1 / ls, x2 / ls, last_dim_is_batch)
        return _kernel_fn(self.covar_dist(x1, x2, diag=diag), kernel_type_for(self))


class PeriodicKernel(Kernel):
    """k(x, x') = exp(−2 Σ_d sin²(π (x_d − x'_d) / p_d) / ℓ_d²), with the period p in
    ``raw_period_length`` of shape batch + (1, d) (one shared period without
    ``ard_num_dims``)."""

    has_lengthscale = True

    def __init__(self, period_length_prior=None, period_length_constraint=None, **kwargs):
        super().__init__(**kwargs)
        num_dims = 1 if self.ard_num_dims is None else self.ard_num_dims
        self.register_parameter("raw_period_length", torch.nn.Parameter(torch.zeros(self.batch_shape + (1, num_dims))))
        self.register_constraint("raw_period_length", period_length_constraint or Positive())
        if period_length_prior is not None:
            self.register_prior("period_length_prior", period_length_prior, lambda m: m.period_length,
                                lambda m, v: m._set_constrained("raw_period_length", v))

    @property
    def period_length(self) -> torch.Tensor:
        return self._constrained("raw_period_length")

    @period_length.setter
    def period_length(self, value) -> None:
        self._set_constrained("raw_period_length", value)

    def hypers(self):
        return {**super().hypers(), "period_length": self.period_length}

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        # each input is reduced to its fractional number of periods before the difference,
        # which sin² does not see, so that far-apart points lose no precision
        per, ls = hypers["period_length"], hypers["lengthscale"]
        a1, a2 = x1 / per, x2 / per
        f1, f2 = a1 - torch.round(a1), a2 - torch.round(a2)
        if last_dim_is_batch:
            # (…, d, n) per dimension, each with its own lengthscale (…, d, 1)
            f1, f2, ls = f1.mT, f2.mT, ls.mT
            diff = f1 - f2 if diag else f1.unsqueeze(-1) - f2.unsqueeze(-2)
            return torch.exp(-2.0 * torch.sin(math.pi * diff) ** 2 / (ls if diag else ls.unsqueeze(-1)) ** 2)
        diff = f1 - f2 if diag else f1[..., :, None, :] - f2[..., None, :, :]
        # 1/ℓ² per input dim, of each batch element: (*batch, 1, d), and one more unit
        # dim against the pairwise differences (*batch, n, m, d)
        inv_l2 = 1.0 / (ls if diag else ls.unsqueeze(-2)) ** 2
        sin2 = torch.sin(math.pi * diff) ** 2
        return torch.exp(-2.0 * (sin2 * inv_l2).sum(-1))
