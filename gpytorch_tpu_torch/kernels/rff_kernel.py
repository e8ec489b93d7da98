"""RFFKernel — random Fourier features.  Counterpart of ``gpytorch_tpu/kernels/rff_kernel.py``.

k(x, x') ≈ φ(x)ᵀφ(x') with φ(x) = [cos(Ωᵀx/ℓ), sin(Ωᵀx/ℓ)] / √D for D = ``num_samples``
standard-normal frequencies Ω (d × D, the buffer ``randn_weights``): an RBF kernel of
lengthscale ℓ in expectation.  On one input the kernel matrix is a ``RootLinearOperator`` of
the features (n × 2D), on two a ``MatmulLinearOperator``; its diagonal is φ(x)ᵀφ(x).

Ω is drawn in float64 from ``generator`` (by default a CPU generator seeded with 0) when
``num_dims`` is given, else at the first evaluation from a CPU generator seeded with 0,
moved to the inputs' device and dtype; the JAX package
draws it from ``PRNGKey(0)``, another stream: carry its ``randn_weights`` with
``load_jax_params`` to compare the two.

The prediction strategy is ``LinearPredictionStrategy`` (caches in feature space).  As in the
JAX package, a ``ScaleKernel`` around this kernel scales the root's operator
(``ConstantMulLinearOperator``), in which the strategy finds no root: it then serves by the
default strategy's math."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..linop import MatmulLinearOperator, RootLinearOperator
from .kernel import Kernel


class RFFKernel(Kernel):
    has_lengthscale = True
    returns_lazy_structure = True

    def __init__(self, num_samples: int, num_dims: Optional[int] = None, generator: Optional[torch.Generator] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.num_samples = int(num_samples)
        if num_dims is not None:
            self._init_weights(num_dims, self.raw_lengthscale.dtype, self.raw_lengthscale.device, generator)

    def _init_weights(self, num_dims: int, dtype, device, generator: Optional[torch.Generator] = None) -> None:
        generator = torch.Generator().manual_seed(0) if generator is None else generator
        weights = torch.randn(self.batch_shape + (num_dims, self.num_samples), generator=generator,
                              dtype=torch.float64, device=generator.device)
        self.register_buffer("randn_weights", weights.to(device=device, dtype=dtype))

    def _featurize(self, x, lengthscale) -> torch.Tensor:
        """[cos, sin] of (x / ℓ) Ω, (…, n, 2D), unnormalised."""
        proj = (x / lengthscale) @ self.randn_weights.to(x.dtype)
        return torch.cat([torch.cos(proj), torch.sin(proj)], -1)

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        if last_dim_is_batch:
            x1, x2 = x1.mT.unsqueeze(-1), x2.mT.unsqueeze(-1)
        if not hasattr(self, "randn_weights"):
            self._init_weights(x1.shape[-1], x1.dtype, x1.device)
        symmetric = x1 is x2
        z1 = self._featurize(x1, hypers["lengthscale"])
        z2 = z1 if symmetric else self._featurize(x2, hypers["lengthscale"])
        D = float(self.num_samples)
        if diag:
            return (z1 * z2).sum(-1) / D
        if symmetric:
            return RootLinearOperator(z1 / math.sqrt(D))
        return MatmulLinearOperator(z1 / D, z2.mT)

    def prediction_strategy(self, train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init=None):
        from ..models.exact_prediction_strategies import LinearPredictionStrategy

        return LinearPredictionStrategy(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init)
