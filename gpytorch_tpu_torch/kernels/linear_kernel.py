"""LinearKernel and PolynomialKernel.  Counterpart of ``gpytorch_tpu/kernels/linear_kernel.py``.

``LinearKernel``: k(x, x') = v·xᵀx'.  On one input its matrix is a ``RootLinearOperator`` of
√v·x (n × d), on two a ``MatmulLinearOperator``, evaluated at every size
(``returns_lazy_structure``), so that products and the pivoted Cholesky's rows go through the
n × d factors; it is served by the default prediction strategy, as in the JAX package.

``PolynomialKernel``: k(x, x') = (xᵀx' + c)^p for an integer power p, taken as an integer
power (its sign for a negative base is the JAX package's ``jnp.power``'s).  It has no fused
product and streams through the lazy operator's blocks of rows.
"""

from __future__ import annotations

import torch

from ..constraints import Positive
from ..linop import MatmulLinearOperator, RootLinearOperator
from .kernel import Kernel
from .stationary import _last_dim_batch


class LinearKernel(Kernel):
    returns_lazy_structure = True

    def __init__(self, num_dimensions=None, offset_prior=None, variance_prior=None, variance_constraint=None,
                 **kwargs):
        super().__init__(**kwargs)
        self.num_dimensions = num_dimensions
        self.register_parameter("raw_variance", torch.nn.Parameter(torch.zeros(self.batch_shape + (1,))))
        self.register_constraint("raw_variance", variance_constraint or Positive())
        if variance_prior is not None:
            self.register_prior("variance_prior", variance_prior, lambda m: m.variance,
                                lambda m, v: m._set_constrained("raw_variance", v))

    @property
    def variance(self) -> torch.Tensor:
        return self._constrained("raw_variance")

    @variance.setter
    def variance(self, value) -> None:
        self._set_constrained("raw_variance", value)

    def hypers(self):
        return {"variance": self.variance}

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        symmetric = x1 is x2
        x1, x2 = _last_dim_batch(x1, x2, last_dim_is_batch)
        scale = torch.sqrt(hypers["variance"]).unsqueeze(-1)  # batch + (1, 1)
        z1 = x1 * scale
        if symmetric and not diag:
            return RootLinearOperator(z1)
        z2 = x2 * scale
        if diag:
            return (z1 * z2).sum(-1)
        return MatmulLinearOperator(z1, z2.mT)


class PolynomialKernel(Kernel):
    def __init__(self, power: int = 2, offset_prior=None, offset_constraint=None, **kwargs):
        super().__init__(**kwargs)
        self.power = int(power)
        self.register_parameter("raw_offset", torch.nn.Parameter(torch.zeros(self.batch_shape + (1,))))
        self.register_constraint("raw_offset", offset_constraint or Positive())
        if offset_prior is not None:
            self.register_prior("offset_prior", offset_prior, lambda m: m.offset,
                                lambda m, v: m._set_constrained("raw_offset", v))

    @property
    def offset(self) -> torch.Tensor:
        return self._constrained("raw_offset")

    @offset.setter
    def offset(self, value) -> None:
        self._set_constrained("raw_offset", value)

    def hypers(self):
        return {"offset": self.offset}

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        x1, x2 = _last_dim_batch(x1, x2, last_dim_is_batch)
        offset = hypers["offset"]
        if diag:
            return torch.pow((x1 * x2).sum(-1) + offset, self.power)
        return torch.pow(x1 @ x2.mT + offset.unsqueeze(-1), self.power)
