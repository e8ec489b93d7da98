"""Kernels built from a base kernel on each input dimension alone.

Counterpart of ``gpytorch_tpu/kernels/structure_kernels.py``: the base kernel evaluated with
``last_dim_is_batch`` gives one matrix per dimension, (…, d, n, m), densified, and

* ``AdditiveStructureKernel`` sums them: k(x, x') = Σ_d k(x_d, x'_d);
* ``ProductStructureKernel`` multiplies them: k(x, x') = Π_d k(x_d, x'_d), which is SKIP
  (arXiv 1802.08903) on a one-dimensional ``GridInterpolationKernel``;
* ``NewtonGirardAdditiveKernel`` adds every order of interaction up to ``max_degree``, each
  with its own outputscale: Σ_k s_k e_k, e_k the elementary symmetric polynomials of the
  per-dimension values, by the Newton–Girard identities from their power sums.

Each densifies d × n × m values, as the JAX package does: these kernels are for a few
thousand points, not for the fused products.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..constraints import Positive
from .kernel import Kernel, _dense, sub_hypers


class _DimensionwiseKernel(Kernel):
    def __init__(self, base_kernel: Kernel, num_dims: int, active_dims=None, **kwargs):
        super().__init__(active_dims=active_dims, **kwargs)
        self.base_kernel = base_kernel
        self.num_dims = int(num_dims)

    def hypers(self):
        return {f"base_kernel.{k}": v for k, v in self.base_kernel.hypers().items()}

    def num_outputs_per_input(self, x1, x2) -> int:
        return self.base_kernel.num_outputs_per_input(x1, x2)

    def _per_dimension(self, hypers, x1, x2, diag: bool, kwargs) -> torch.Tensor:
        if kwargs.get("last_dim_is_batch"):
            raise RuntimeError(f"{type(self).__name__} does not accept last_dim_is_batch")
        return _dense(self.base_kernel.evaluate(sub_hypers(hypers, "base_kernel."), x1, x2, diag=diag,
                                                last_dim_is_batch=True))


class AdditiveStructureKernel(_DimensionwiseKernel):
    def evaluate(self, hypers, x1, x2, diag: bool = False, **kwargs):
        return self._per_dimension(hypers, x1, x2, diag, kwargs).sum(-2 if diag else -3)


class ProductStructureKernel(_DimensionwiseKernel):
    def evaluate(self, hypers, x1, x2, diag: bool = False, **kwargs):
        return self._per_dimension(hypers, x1, x2, diag, kwargs).prod(-2 if diag else -3)


class NewtonGirardAdditiveKernel(_DimensionwiseKernel):
    """``raw_outputscale`` of shape batch + (max_degree,): one outputscale per order."""

    def __init__(self, base_kernel: Kernel, num_dims: int, max_degree: Optional[int] = None, active_dims=None,
                 **kwargs):
        super().__init__(base_kernel, num_dims, active_dims=active_dims, **kwargs)
        self.max_degree = int(min(num_dims if max_degree is None else max_degree, num_dims))
        self.register_parameter("raw_outputscale", torch.nn.Parameter(torch.zeros(self.batch_shape + (self.max_degree,))))
        self.register_constraint("raw_outputscale", Positive())

    @property
    def outputscale(self) -> torch.Tensor:
        return self._constrained("raw_outputscale")

    @outputscale.setter
    def outputscale(self, value) -> None:
        self._set_constrained("raw_outputscale", value)

    def hypers(self):
        return {**super().hypers(), "outputscale": self.outputscale}

    def num_outputs_per_input(self, x1, x2) -> int:
        return 1

    def evaluate(self, hypers, x1, x2, diag: bool = False, **kwargs):
        values = self._per_dimension(hypers, x1, x2, diag, kwargs)
        axis = -2 if diag else -3
        # power sums p_k = Σ_d z_d^k; e_0 = 1, e_k = (1/k) Σ_{i=1..k} (−1)^{i−1} e_{k−i} p_i
        p = [(values ** k).sum(axis) for k in range(self.max_degree + 1)]
        e = [torch.ones_like(p[1])]
        for k in range(1, self.max_degree + 1):
            acc = torch.zeros_like(p[1])
            for i in range(1, k + 1):
                acc = acc + ((-1.0) ** (i - 1)) * e[k - i] * p[i]
            e.append(acc / k)
        scales = hypers["outputscale"]
        out = torch.zeros_like(e[1])
        for k in range(1, self.max_degree + 1):
            s = scales[..., k - 1]
            out = out + s.reshape(s.shape + (1,) * (out.ndim - s.ndim)) * e[k]
        return out
