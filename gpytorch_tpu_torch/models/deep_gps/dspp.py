"""Deep sigma point processes (DSPP).  Counterpart of ``gpytorch_tpu/models/deep_gps/dspp.py``.

A ``DSPPLayer`` propagates its inputs through Q deterministic quadrature sites in place of
random samples: given a ``MultitaskMultivariateNormal`` with mean μ and variance σ² it
takes the points μ + q_s σ, one per site q_s (each site's own on a later layer, whose inputs
already carry the site dimension first), from ``quad_sites``, a parameter of Q scalars
initially the probabilists' Gauss–Hermite nodes.  Given deterministic inputs, its output is
repeated over the Q sites.  ``DSPP`` holds the learned quadrature weights, log-softmax of
``raw_quad_weights``, with which ``mlls.DeepPredictiveLogLikelihood`` mixes the sites.
"""

from __future__ import annotations

import numpy as np
import torch

from ...distributions import MultitaskMultivariateNormal
from ...linop import BlockDiagLinearOperator, DenseLinearOperator
from ..approximate_gp import ApproximateGP
from .deep_gp import DeepGP, DeepGPLayer


class DSPPLayer(DeepGPLayer):
    def __init__(self, variational_strategy, input_dims, output_dims, num_quad_sites: int = 8, quad_sites=None):
        super().__init__(variational_strategy, input_dims, output_dims)
        self.num_quad_sites = int(num_quad_sites)
        if quad_sites is None:
            quad_sites = np.polynomial.hermite_e.hermegauss(self.num_quad_sites)[0]
        self.register_parameter("quad_sites", torch.nn.Parameter(torch.as_tensor(quad_sites, dtype=torch.float32)))

    def __call__(self, inputs, **kwargs):
        are_samples = isinstance(inputs, MultitaskMultivariateNormal)
        if are_samples:
            mean, std = inputs.mean, inputs.variance.sqrt()
            Q = self.num_quad_sites
            if mean.ndim >= 3 and mean.shape[0] == Q:  # one point per site already: each its own site
                inputs = mean + self.quad_sites.reshape((Q,) + (1,) * (mean.ndim - 1)) * std
            else:
                inputs = mean.unsqueeze(0) + self.quad_sites.reshape((Q,) + (1,) * mean.ndim) * std.unsqueeze(0)
        if inputs.ndim == 1:
            inputs = inputs.unsqueeze(-1)
        x = inputs
        if self.output_dims is not None:
            x = inputs.unsqueeze(-3).expand(inputs.shape[:-2] + (self.output_dims,) + inputs.shape[-2:])
        output = ApproximateGP.__call__(self, x, **kwargs)
        if self.output_dims is not None:
            output = MultitaskMultivariateNormal(output.mean.mT,
                                                 BlockDiagLinearOperator(DenseLinearOperator(output.covariance_matrix)),
                                                 interleaved=False)
        if not are_samples and self.num_quad_sites > 0:
            output = output.expand((self.num_quad_sites,) + tuple(output.batch_shape))
        return output


class DSPP(DeepGP):
    def __init__(self, num_quad_sites: int):
        super().__init__()
        self.num_quad_sites = int(num_quad_sites)
        self.register_parameter("raw_quad_weights", torch.nn.Parameter(torch.zeros(self.num_quad_sites)))

    @property
    def quad_weights(self) -> torch.Tensor:
        """log w_s, a log-softmax over the sites."""
        return torch.log_softmax(self.raw_quad_weights, dim=-1)
