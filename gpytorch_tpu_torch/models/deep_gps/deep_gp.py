"""Deep GPs.  Counterpart of ``gpytorch_tpu/models/deep_gps/deep_gp.py``.

A ``DeepGPLayer`` is an ``ApproximateGP`` over ``output_dims`` independent GPs (the batch of
its strategy, kernel and mean).  Given deterministic inputs (n, d) it returns a task-major
``MultitaskMultivariateNormal`` over (n, output_dims), its covariance the
``BlockDiagLinearOperator`` of each output's dense covariance, repeated over
``settings.num_likelihood_samples`` samples (``expand``, no copy).  Given such a
distribution, the next layer draws one joint sample of all n·output_dims values per
sample from the root decomposition of the whole block-diagonal covariance: up to
``settings.max_cholesky_size`` values its Cholesky factor, above it a Lanczos root of rank
``settings.max_root_decomposition_size``, as the JAX package draws it (GPyTorch draws
each point from its marginal).  The draws' base samples come from ``base_samples`` (a
``torch.Generator``, or a callable that returns them for a shape) in place of a JAX key;
``are_samples=True`` takes the inputs as samples already drawn.

``DeepGP`` holds the layers; the subclass defines ``forward``.  ``deep_kl_divergence`` sums
the KL terms of every ``ApproximateGP`` among its modules.
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import settings
from ...distributions import MultitaskMultivariateNormal, MultivariateNormal
from ...linop import BlockDiagLinearOperator, DenseLinearOperator
from ..approximate_gp import ApproximateGP
from ..gp import GP


class DeepGPLayer(ApproximateGP):
    def __init__(self, variational_strategy, input_dims: Optional[int], output_dims: Optional[int]):
        super().__init__(variational_strategy)
        self.input_dims = input_dims
        self.output_dims = output_dims

    def __call__(self, inputs, base_samples=None, are_samples: bool = False, **kwargs):
        deterministic_inputs = not are_samples
        if isinstance(inputs, MultitaskMultivariateNormal):
            inputs, deterministic_inputs = inputs.rsample(base_samples=base_samples), False
        elif isinstance(inputs, MultivariateNormal):
            inputs, deterministic_inputs = inputs.rsample(base_samples=base_samples).unsqueeze(-1), False
        if inputs.ndim == 1:
            inputs = inputs.unsqueeze(-1)
        if settings.debug.on() and self.input_dims is not None and inputs.shape[-1] != self.input_dims:
            raise RuntimeError(f"Input shape did not match self.input_dims. Got total feature dims "
                               f"[{inputs.shape[-1]}], expected [{self.input_dims}]")
        if self.output_dims is not None:  # one GP per output dimension, as a batch
            inputs = inputs.unsqueeze(-3).expand(inputs.shape[:-2] + (self.output_dims,) + inputs.shape[-2:])
        output = super().__call__(inputs, **kwargs)
        if self.output_dims is not None:
            output = MultitaskMultivariateNormal(output.mean.mT,
                                                 BlockDiagLinearOperator(DenseLinearOperator(output.covariance_matrix)),
                                                 interleaved=False)
        if deterministic_inputs:
            output = output.expand((settings.num_likelihood_samples.value(),) + tuple(output.batch_shape))
        return output


class DeepGP(GP):
    def deep_kl_divergence(self) -> torch.Tensor:
        """Σ over the layers of their summed KL(q(u) ‖ p(u))."""
        total = None
        for module in self.modules():
            if isinstance(module, ApproximateGP):
                kl = module.variational_strategy.kl_divergence(model=module).sum()
                total = kl if total is None else total + kl
        return total
