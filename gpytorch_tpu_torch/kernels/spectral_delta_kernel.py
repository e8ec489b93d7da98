"""SpectralDeltaKernel: a spectral density of Q point masses z_q, k(x, x') = (1/Q) Σ_q
cos(2π (x − x')ᵀ diag(1/ℓ) z_q), as the feature map φ(x) = [cos, sin](2π (x/ℓ) Zᵀ).

Counterpart of ``gpytorch_tpu/kernels/spectral_delta_kernel.py``.  On one input the matrix is
a ``RootLinearOperator`` of φ/√Q (n × 2Q), on two a ``MatmulLinearOperator``, evaluated at
every size (``returns_lazy_structure``).  ``raw_Z`` (batch + (Q, d), behind ``Positive``)
starts as 0.01 × a standard-normal draw from a CPU ``torch.Generator`` seeded with 0; the JAX
package draws it from ``PRNGKey(0)``, another stream: carry it with ``load_jax_params``, or
set it from data with ``initialize_from_data`` (the JAX package's numpy code).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constraints import Positive
from ..linop import MatmulLinearOperator, RootLinearOperator
from .kernel import Kernel
from .spectral_mixture_kernel import _numpy
from .stationary import _last_dim_batch


class SpectralDeltaKernel(Kernel):
    has_lengthscale = True
    returns_lazy_structure = True

    def __init__(self, num_dims: int, num_deltas: int = 128, Z_constraint=None, **kwargs):
        super().__init__(ard_num_dims=num_dims, **kwargs)
        self.num_deltas = int(num_deltas)
        z = 0.01 * torch.randn(self.batch_shape + (self.num_deltas, int(num_dims)),
                               generator=torch.Generator().manual_seed(0))
        self.register_parameter("raw_Z", torch.nn.Parameter(z))
        self.register_constraint("raw_Z", Z_constraint or Positive())

    @property
    def Z(self) -> torch.Tensor:
        return self._constrained("raw_Z")

    @Z.setter
    def Z(self, value) -> None:
        self._set_constrained("raw_Z", value)

    def hypers(self):
        return {**super().hypers(), "Z": self.Z}

    def initialize_from_data(self, train_x, train_y=None) -> "SpectralDeltaKernel":
        """Deltas uniform on [0, 1 / the input range) per dimension, ``RandomState(0)``."""
        train_x = _numpy(train_x)
        if train_x.ndim == 1:
            train_x = train_x[:, None]
        train_x_sort = np.sort(train_x, axis=-2)
        max_dist = train_x_sort[-1, :] - train_x_sort[0, :] + 1e-12
        self.Z = np.random.RandomState(0).rand(self.num_deltas, train_x.shape[-1]) / max_dist
        return self

    @staticmethod
    def _featurize(x, lengthscale, Z):
        proj = 2.0 * math.pi * ((x / lengthscale) @ Z.mT)  # (…, n, Q)
        return torch.cat([torch.cos(proj), torch.sin(proj)], -1)

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        symmetric = x1 is x2
        x1, x2 = _last_dim_batch(x1, x2, last_dim_is_batch)
        ls, Z = hypers["lengthscale"], hypers["Z"]
        z1 = self._featurize(x1, ls, Z)
        z2 = z1 if symmetric else self._featurize(x2, ls, Z)
        Q = float(self.num_deltas)
        if diag:
            return (z1 * z2).sum(-1) / Q
        if symmetric:
            return RootLinearOperator(z1 / math.sqrt(Q))
        return MatmulLinearOperator(z1 / Q, z2.mT)
