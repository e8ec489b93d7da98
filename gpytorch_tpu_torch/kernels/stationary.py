"""Stationary kernels: RBF, Matérn, periodic, rational quadratic and cosine.

Counterpart of ``gpytorch_tpu/kernels/stationary.py``.  RBF, Matérn and periodic map onto
their fused kernel products (``ops/fused_kernels.py``, ``ops/periodic_kernels.py``)
whenever K is too large to evaluate densely; RQ and cosine have none, in either package,
and stream through the lazy operator's blocks of rows (``_matmul_chunked``).  With
``last_dim_is_batch`` each evaluates one matrix per input dimension, (…, d, n, m), from
the inputs scaled as usual (``_last_dim_batch``).
"""

from __future__ import annotations

import math

import torch

from ..constraints import Positive
from ..ops.fused_kernels import _kernel_fn, kernel_type_for
from ..ops.sq_dist import sq_dist
from .kernel import Kernel


def _last_dim_batch(x1, x2, last_dim_is_batch: bool):
    """(…, n, d) inputs as (…, d, n, 1) with ``last_dim_is_batch``: each dimension alone."""
    if last_dim_is_batch:
        return x1.mT.unsqueeze(-1), x2.mT.unsqueeze(-1)
    return x1, x2


def _dist(x1, x2, diag: bool = False):
    """Pairwise distances, floored under the square root at 1e-30 as the JAX package's
    ``covar_dist`` floors them; on one input (``x1 is x2``) the diagonal is exactly 0, as
    the JAX package's ``dist`` makes it: the expansion's round-off there, ≈ 1e-16 of the
    squared norms, would be ≈ 1e-8 under the square root."""
    if diag:
        return torch.sqrt(torch.clamp_min(((x1 - x2) ** 2).sum(-1), 1e-30))
    r = torch.sqrt(torch.clamp_min(sq_dist(x1, x2), 1e-30))
    if x1 is x2:
        r = r.masked_fill(torch.eye(r.shape[-1], dtype=torch.bool, device=r.device), 0.0)
    return r


def _divided(x1, x2, scale):
    """(x1 / scale, x2 / scale), one tensor twice where x1 is x2."""
    a = x1 / scale
    return a, a if x2 is x1 else x2 / scale


def _positive_parameter(module, name: str, shape, prior=None, constraint=None) -> None:
    """Register the raw parameter ``raw_<name>`` of ``shape`` (zeros) behind ``constraint``
    (``Positive`` by default), with ``prior`` on its constrained value as ``<name>_prior``."""
    module.register_parameter(f"raw_{name}", torch.nn.Parameter(torch.zeros(shape)))
    module.register_constraint(f"raw_{name}", constraint or Positive())
    if prior is not None:
        module.register_prior(f"{name}_prior", prior, lambda m: m._constrained(f"raw_{name}"),
                              lambda m, v: m._set_constrained(f"raw_{name}", v))


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
        _positive_parameter(self, "period_length", self.batch_shape + (1, num_dims), period_length_prior,
                            period_length_constraint)

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


class RQKernel(Kernel):
    """Rational quadratic: k = (1 + ‖(x−x')/ℓ‖² / 2α)^(−α), with α in ``raw_alpha`` of shape
    batch + (1,)."""

    has_lengthscale = True

    def __init__(self, alpha_constraint=None, **kwargs):
        super().__init__(**kwargs)
        _positive_parameter(self, "alpha", self.batch_shape + (1,), constraint=alpha_constraint)

    @property
    def alpha(self) -> torch.Tensor:
        return self._constrained("raw_alpha")

    @alpha.setter
    def alpha(self, value) -> None:
        self._set_constrained("raw_alpha", value)

    def hypers(self):
        return {**super().hypers(), "alpha": self.alpha}

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        ls, alpha = hypers["lengthscale"], hypers["alpha"]
        x1, x2 = _last_dim_batch(x1 / ls, x2 / ls, last_dim_is_batch)
        d2 = self.covar_dist(x1, x2, diag=diag)
        alpha = alpha.reshape(alpha.shape + (1,) * (d2.ndim - len(self.batch_shape) - 1))
        return torch.pow(1.0 + d2 / (2.0 * alpha), -alpha)


class CosineKernel(Kernel):
    """k = cos(2π ‖x − x'‖ / p), with one period p in ``raw_period_length`` of shape
    batch + (1, 1)."""

    def __init__(self, period_length_prior=None, period_length_constraint=None, **kwargs):
        super().__init__(**kwargs)
        _positive_parameter(self, "period_length", self.batch_shape + (1, 1), period_length_prior,
                            period_length_constraint)

    @property
    def period_length(self) -> torch.Tensor:
        return self._constrained("raw_period_length")

    @period_length.setter
    def period_length(self, value) -> None:
        self._set_constrained("raw_period_length", value)

    def hypers(self):
        return {"period_length": self.period_length}

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        x1, x2 = _last_dim_batch(*_divided(x1, x2, hypers["period_length"]), last_dim_is_batch)
        return torch.cos(2.0 * math.pi * _dist(x1, x2, diag))
