"""gpytorch_tpu_torch — the PyTorch and CUDA port of gpytorch_tpu.

Module paths mirror ``gpytorch_tpu/`` so that each counterpart is easy to find.  This
package imports ``torch`` and never ``jax``.  What is ported so far is exact-GP serving,
sampling and training.  Serving: the posterior mean from a CG-solved cache (optionally
refined) and LOVE variances from a block-Lanczos inverse root; LOVE posterior samples from
the Lanczos root of the predictive covariance.  Training: the exact marginal log
likelihood by mBCG with stochastic Lanczos quadrature, differentiated by the BBMM
backward, plus the log-densities of the parameters' priors, with NaN targets masked or
filled.  Fantasy models conditioned on new points, and predictions differentiated through
their caches (``settings.detach_test_caches(False)``).  Batches of independent GPs
(``batch_shape`` on every kernel, mean and likelihood) and multitask GPs (Kronecker, LCM
and Hadamard).  Sparse variational GPs (whitened, unwhitened, CIQ, large-batch, decoupled,
grid-interpolation, nearest-neighbour, and independent and LMC multitask strategies, natural
gradients), two-layer deep GPs and DSPPs, and the sparse exact GPs SGPR and random Fourier
features.  Up to
``settings.max_cholesky_size`` points, each of these takes a dense Cholesky factor.  Every product with
the kernel matrix, and its gradient, goes through the fused kernel products
(``ops/fused_kernels.py``): hand-written CUDA kernels on the GPU.
"""

from __future__ import annotations

from . import (constraints, distributions, kernels, likelihoods, linop, means, metrics, mlls, models, ops, optim,
               priors, settings, solvers, variational)
from .core.module import Module
from .utils import load_jax_params

__all__ = [
    "Module",
    "constraints",
    "distributions",
    "kernels",
    "likelihoods",
    "linop",
    "load_jax_params",
    "means",
    "metrics",
    "mlls",
    "models",
    "ops",
    "optim",
    "priors",
    "settings",
    "solvers",
    "variational",
]
