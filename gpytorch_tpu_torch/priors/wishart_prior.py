"""Wishart and inverse Wishart priors over p × p positive-definite matrices.  Counterpart of
``gpytorch_tpu/priors/wishart_prior.py``, with its sampler: for ν' = max(⌊ν⌋, p + 1), the
Gram matrix of ν' Gaussian columns of covariance K, times ν/ν' (an exact Wishart(ν, K) draw
for an integer ν > p; its mean is ν K for any ν)."""

from __future__ import annotations

import math

import torch

from .prior import Prior
from .torch_priors import _buffer


class WishartPrior(Prior):
    """W(ν, K): p(X) ∝ |X|^((ν − p − 1)/2) exp(−tr(K⁻¹X)/2)."""

    def __init__(self, nu, K):
        super().__init__()
        K = _buffer(K)
        self.p = K.shape[-1]
        nu = torch.as_tensor(nu, dtype=K.dtype, device=K.device)
        self.register_buffer("nu", nu)
        self.register_buffer("K_inv", torch.linalg.inv(K))
        self.register_buffer("C", -(nu / 2) * (torch.linalg.slogdet(K)[1] + self.p * math.log(2.0))
                             - torch.special.multigammaln(nu / 2, self.p))

    def log_prob(self, X: torch.Tensor) -> torch.Tensor:
        trace = torch.diagonal(self.K_inv @ X, dim1=-2, dim2=-1).sum(-1)
        return self.C + 0.5 * ((self.nu - self.p - 1) * torch.linalg.slogdet(X)[1] - trace)

    def sample(self, sample_shape=(), generator=None) -> torch.Tensor:
        cols = max(int(self.nu), self.p + 1)
        A = torch.randn(tuple(sample_shape) + (self.p, cols), generator=generator, dtype=self.K_inv.dtype,
                        device=self.K_inv.device)
        B = torch.linalg.cholesky(torch.linalg.inv(self.K_inv)) @ A
        return B @ B.mT / cols * self.nu


class InverseWishartPrior(Prior):
    """IW(ν, K): p(X) ∝ |X|^(−(ν + p + 1)/2) exp(−tr(K X⁻¹)/2); draws are inverses of
    W(ν, K⁻¹) draws."""

    def __init__(self, nu, K):
        super().__init__()
        K = _buffer(K)
        self.p = K.shape[-1]
        nu = torch.as_tensor(nu, dtype=K.dtype, device=K.device)
        self.register_buffer("nu", nu)
        self.register_buffer("K", K)
        self.register_buffer("C", (nu / 2) * torch.linalg.slogdet(K)[1] - (nu * self.p / 2) * math.log(2.0)
                             - torch.special.multigammaln(nu / 2, self.p))

    def log_prob(self, X: torch.Tensor) -> torch.Tensor:
        trace = torch.diagonal(self.K @ torch.linalg.inv(X), dim1=-2, dim2=-1).sum(-1)
        return self.C - 0.5 * ((self.nu + self.p + 1) * torch.linalg.slogdet(X)[1] + trace)

    def sample(self, sample_shape=(), generator=None) -> torch.Tensor:
        W = WishartPrior(self.nu, torch.linalg.inv(self.K)).sample(sample_shape, generator)
        return torch.linalg.inv(W)
