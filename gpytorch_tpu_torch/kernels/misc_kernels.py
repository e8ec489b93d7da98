"""The long tail of kernels: Arc, Cylindrical, Gibbs, HammingIMQ, SphericalLinear,
DistributionalInput and GaussianSymmetrizedKL, with the helpers ``hamming_dist`` and
``project_onto_unit_sphere``.

Counterpart of ``gpytorch_tpu/kernels/misc_kernels.py``.  None has a fused product: above
``max_eager_kernel_size``² the lazy operator streams K·V by blocks of rows.  The JAX
package's callables (Arc's ``delta_func``, Gibbs's ``lengthscale_function``, the
distributional kernel's ``distance_function``) take and return torch tensors here.  A
kernel built on another (Arc, Cylindrical) evaluates it from its own hyperparameters,
under the prefix of its attribute (``base_kernel.``, ``radial_base_kernel.``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..constraints import Interval, Positive
from .kernel import Kernel, _dense, sub_hypers


def _ones_delta(x: torch.Tensor) -> torch.Tensor:
    """The default delta and lengthscale function: one per input row."""
    return torch.ones_like(x[..., 0])


def _reshape_to(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """t with unit dimensions appended up to ``ndim``."""
    return t.reshape(t.shape + (1,) * (ndim - t.ndim))


class ArcKernel(Kernel):
    """The base kernel on the inputs embedded on arcs: e(x) = r·[sin, cos](π a x / ℓ) per
    dimension, with angle a ∈ (0, 1) and radius r of shape batch + (1, d) (arXiv 1806.08195).
    The base kernel's lengthscale is set to 1."""

    has_lengthscale = True

    def __init__(self, base_kernel: Kernel, delta_func: Optional[Callable] = None, angle_prior=None,
                 radius_prior=None, **kwargs):
        super().__init__(**kwargs)
        if base_kernel.has_lengthscale:
            base_kernel.lengthscale = 1.0
        self.base_kernel = base_kernel
        self.delta_func = _ones_delta if delta_func is None else delta_func
        num_dims = 1 if self.ard_num_dims is None else self.ard_num_dims
        self.register_parameter("raw_angle", torch.nn.Parameter(torch.zeros(self.batch_shape + (1, num_dims))))
        self.register_constraint("raw_angle", Interval(0.0, 1.0))
        self.register_parameter("raw_radius", torch.nn.Parameter(torch.zeros(self.batch_shape + (1, num_dims))))
        self.register_constraint("raw_radius", Positive())
        if angle_prior is not None:
            self.register_prior("angle_prior", angle_prior, lambda m: m.angle,
                                lambda m, v: m._set_constrained("raw_angle", v))
        if radius_prior is not None:
            self.register_prior("radius_prior", radius_prior, lambda m: m.radius,
                                lambda m, v: m._set_constrained("raw_radius", v))

    @property
    def angle(self) -> torch.Tensor:
        return self._constrained("raw_angle")

    @angle.setter
    def angle(self, value) -> None:
        self._set_constrained("raw_angle", value)

    @property
    def radius(self) -> torch.Tensor:
        return self._constrained("raw_radius")

    @radius.setter
    def radius(self, value) -> None:
        self._set_constrained("raw_radius", value)

    def hypers(self):
        base = {f"base_kernel.{k}": v for k, v in self.base_kernel.hypers().items()}
        return {**super().hypers(), "angle": self.angle, "radius": self.radius, **base}

    @staticmethod
    def _embedding(hypers, x):
        angles = math.pi * hypers["angle"] * (x / hypers["lengthscale"])
        return torch.cat([hypers["radius"] * torch.sin(angles), hypers["radius"] * torch.cos(angles)], -1)

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        e1, e2 = self._embedding(hypers, x1), self._embedding(hypers, x2)
        return self.base_kernel.evaluate(sub_hypers(hypers, "base_kernel."), e1, e2, diag=diag)


class CylindricalKernel(Kernel):
    """Radius × angle (Oh et al., 2018, BOCK): Σ_p w_p cos^p θ of the angle θ between the
    inputs, times the radial base kernel of their norms warped by a Kumaraswamy CDF
    1 − (1 − r^α)^β, with α ∈ (eps, 1) and β > 0."""

    def __init__(self, num_angular_weights: int, radial_base_kernel: Kernel, eps: float = 1e-6,
                 angular_weights_constraint=None, alpha_constraint=None, beta_constraint=None, **kwargs):
        super().__init__(**kwargs)
        self.num_angular_weights = int(num_angular_weights)
        self.radial_base_kernel = radial_base_kernel
        self.eps_val = float(eps)
        for name, shape, constraint in (
                ("angular_weights", (self.num_angular_weights,), angular_weights_constraint or Positive()),
                ("alpha", (1,), alpha_constraint or Interval(self.eps_val, 1.0)),
                ("beta", (1,), beta_constraint or Positive())):
            self.register_parameter(f"raw_{name}", torch.nn.Parameter(torch.zeros(self.batch_shape + shape)))
            self.register_constraint(f"raw_{name}", constraint)

    @property
    def angular_weights(self) -> torch.Tensor:
        return self._constrained("raw_angular_weights")

    @property
    def alpha(self) -> torch.Tensor:
        return self._constrained("raw_alpha")

    @property
    def beta(self) -> torch.Tensor:
        return self._constrained("raw_beta")

    def hypers(self):
        radial = {f"radial_base_kernel.{k}": v for k, v in self.radial_base_kernel.hypers().items()}
        return {"angular_weights": self.angular_weights, "alpha": self.alpha, "beta": self.beta, **radial}

    def kuma(self, hypers, x):
        alpha, beta = hypers["alpha"].unsqueeze(-1), hypers["beta"].unsqueeze(-1)
        return 1.0 - (1.0 - torch.clamp(x, self.eps_val, 1.0 - self.eps_val) ** alpha) ** beta

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        r1 = torch.linalg.vector_norm(x1, dim=-1, keepdim=True)
        r2 = torch.linalg.vector_norm(x2, dim=-1, keepdim=True)
        a1, a2 = x1 / torch.clamp_min(r1, self.eps_val), x2 / torch.clamp_min(r2, self.eps_val)
        cos_angle = torch.clamp((a1 * a2).sum(-1) if diag else a1 @ a2.mT, -1.0, 1.0)
        w = hypers["angular_weights"]
        angular = torch.zeros_like(cos_angle)
        for p in range(self.num_angular_weights):
            angular = angular + _reshape_to(w[..., p], cos_angle.ndim) * cos_angle**p
        radial = self.radial_base_kernel.evaluate(sub_hypers(hypers, "radial_base_kernel."), self.kuma(hypers, r1),
                                                  self.kuma(hypers, r2), diag=diag)
        return angular * _dense(radial)


class GibbsKernel(Kernel):
    """The non-stationary RBF of an input-dependent lengthscale ℓ(x) (a callable of the
    inputs (…, n, d) that returns (…, n)): k = √(2ℓℓ' / (ℓ² + ℓ'²)) exp(−‖x − x'‖² / (ℓ² + ℓ'²))."""

    def __init__(self, lengthscale_function: Optional[Callable] = None, **kwargs):
        super().__init__(**kwargs)
        self.lengthscale_function = _ones_delta if lengthscale_function is None else lengthscale_function

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        l1, l2 = self.lengthscale_function(x1), self.lengthscale_function(x2)
        if diag:
            d2 = ((x1 - x2) ** 2).sum(-1)
        else:
            l1, l2 = l1.unsqueeze(-1), l2.unsqueeze(-2)
            d2 = ((x1.unsqueeze(-2) - x2.unsqueeze(-3)) ** 2).sum(-1)
        denom = l1**2 + l2**2
        return torch.sqrt(2.0 * l1 * l2 / denom) * torch.exp(-d2 / denom)


class HammingIMQKernel(Kernel):
    """The inverse multi-quadratic kernel of the Hamming distance h of one-hot sequences
    (inputs (…, n, L·V) for L positions of a vocabulary of V): k = ((1 + α) / (α + h))^β,
    α and β of shape batch_shape."""

    def __init__(self, vocab_size: int, batch_shape=(), alpha_constraint=None, beta_constraint=None, **kwargs):
        super().__init__(batch_shape=batch_shape, **kwargs)
        self.vocab_size = int(vocab_size)
        for name, constraint in (("alpha", alpha_constraint), ("beta", beta_constraint)):
            self.register_parameter(f"raw_{name}", torch.nn.Parameter(torch.zeros(self.batch_shape)))
            self.register_constraint(f"raw_{name}", constraint or Positive())

    @property
    def alpha(self) -> torch.Tensor:
        return self._constrained("raw_alpha")

    @alpha.setter
    def alpha(self, value) -> None:
        self._set_constrained("raw_alpha", value)

    @property
    def beta(self) -> torch.Tensor:
        return self._constrained("raw_beta")

    @beta.setter
    def beta(self, value) -> None:
        self._set_constrained("raw_beta", value)

    def hypers(self):
        return {"alpha": self.alpha, "beta": self.beta}

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        seq_len = x1.shape[-1] // self.vocab_size
        x1r = x1.reshape(x1.shape[:-1] + (seq_len, self.vocab_size))
        x2r = x2.reshape(x2.shape[:-1] + (seq_len, self.vocab_size))
        if diag:
            matches = (x1r * x2r).sum(-1).sum(-1)
        else:
            matches = torch.einsum("...nsv,...msv->...nm", x1r, x2r)
        hamming = seq_len - matches
        alpha, beta = (_reshape_to(hypers[k], hamming.ndim) for k in ("alpha", "beta"))
        return ((1.0 + alpha) / (alpha + hamming)) ** beta


class SphericalLinearKernel(Kernel):
    """The first-order arc-cosine kernel of the inputs' directions: sin θ + (π − θ) cos θ
    for the angle θ between them."""

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        n1 = x1 / torch.clamp_min(torch.linalg.vector_norm(x1, dim=-1, keepdim=True), 1e-12)
        n2 = x2 / torch.clamp_min(torch.linalg.vector_norm(x2, dim=-1, keepdim=True), 1e-12)
        cos = torch.clamp((n1 * n2).sum(-1) if diag else n1 @ n2.mT, -1.0, 1.0)
        theta = torch.arccos(cos)
        return torch.sin(theta) + (math.pi - theta) * cos


class DistributionalInputKernel(Kernel):
    """A kernel over input distributions: k = exp(−div(p, q) / ℓ) for a divergence
    ``distance_function(x1, x2, diag=...)`` of the inputs that parameterise them."""

    has_lengthscale = True

    def __init__(self, distance_function: Callable, **kwargs):
        super().__init__(**kwargs)
        if distance_function is None:
            raise RuntimeError("distance_function is required")
        self.distance_function = distance_function

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        div = self.distance_function(x1, x2, diag=diag)
        return torch.exp(-div / _reshape_to(hypers["lengthscale"][..., 0, 0], div.ndim))


def _symmetrized_kl_distance(x1, x2, diag: bool = False):
    """Σ_d KL(p‖q) + KL(q‖p) of diagonal Gaussians whose means are the inputs' first half of
    columns and whose log-variances are the second half."""
    d = x1.shape[-1] // 2
    mu1, v1, mu2, v2 = x1[..., :d], torch.exp(x1[..., d:]), x2[..., :d], torch.exp(x2[..., d:])
    if not diag:
        mu1, v1, mu2, v2 = mu1.unsqueeze(-2), v1.unsqueeze(-2), mu2.unsqueeze(-3), v2.unsqueeze(-3)
    sq = (mu1 - mu2) ** 2
    kl12 = 0.5 * ((v1 + sq) / v2 + torch.log(v2) - torch.log(v1) - 1.0)
    kl21 = 0.5 * ((v2 + sq) / v1 + torch.log(v1) - torch.log(v2) - 1.0)
    return (kl12 + kl21).sum(-1)


class GaussianSymmetrizedKLKernel(DistributionalInputKernel):
    """``DistributionalInputKernel`` of the symmetrised KL divergence of diagonal Gaussians
    (inputs: means, then log-variances)."""

    def __init__(self, **kwargs):
        super().__init__(distance_function=_symmetrized_kl_distance, **kwargs)


def hamming_dist(x1, x2, x1_eq_x2: bool = False):
    """Pairwise Hamming distances of one-hot sequences (…, n, L, V) and (…, m, L, V)."""
    res = x1.shape[-2] - (x1.unsqueeze(-3) * x2.unsqueeze(-4)).sum((-1, -2))
    return torch.clamp_min(res, 0.0)


def project_onto_unit_sphere(x):
    """The inverse stereographic projection of x (…, d) onto the unit sphere in d + 1
    dimensions."""
    x_sq_norm = (x * x).sum(-1, keepdim=True)
    return torch.cat([2 * x, x_sq_norm - 1.0], -1) / (1.0 + x_sq_norm)
