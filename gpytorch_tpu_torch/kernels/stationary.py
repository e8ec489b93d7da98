"""RBF kernel with (ARD) lengthscales.

Counterpart of ``RBFKernel`` in ``gpytorch_tpu/kernels/stationary.py``.  It maps onto the
fused kernel matvec (``ops/fused_kernels.py``) whenever K is too large to evaluate densely.
"""

from __future__ import annotations

import torch

from .kernel import Kernel


class RBFKernel(Kernel):
    """k(x, x') = exp(−½‖(x−x')/ℓ‖²)."""

    has_lengthscale = True

    def evaluate(self, hypers, x1, x2, diag: bool = False):
        ls = hypers["lengthscale"]
        return torch.exp(-0.5 * self.covar_dist(x1 / ls, x2 / ls, diag=diag))
