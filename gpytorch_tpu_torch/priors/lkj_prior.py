"""LKJ priors over correlation matrices, their Cholesky factors, and covariance matrices.
Counterpart of ``gpytorch_tpu/priors/lkj_prior.py``.

LKJ(n, η) has density c(n, η)⁻¹ det(R)^(η−1) over n × n correlation matrices R, with the JAX
package's normaliser ``_lkj_log_norm_const``.  Over Cholesky factors L (R = L Lᵀ) the density
is c⁻¹ Πᵢ L_ii^(n − i + 2η − 2), i = 1..n, as in Lewandowski, Kurowicka and Joe (2009), Stan
and ``torch.distributions.LKJCholesky``.  (The JAX package's exponent is one higher.)

``sample`` draws LKJ(η) exactly by the onion method: row i of L (i ≥ 2) is √y · u on the unit
sphere of its first i − 1 coordinates, y ~ Beta((i − 1)/2, η + (n − i)/2), with diagonal
√(1 − y).  The Beta draws are gamma ratios from ``_standard_gamma``, so every draw comes from
the one generator given.  (The JAX package's sampler takes the correlation of A Aᵀ for a
Gaussian n × (n + 2) matrix A, which is LKJ(1.5) whatever η is.)"""

from __future__ import annotations

import math

import torch

from .prior import Prior
from .torch_priors import _buffer, _standard_gamma


def _lkj_log_norm_const(n: int, eta: torch.Tensor) -> torch.Tensor:
    """log c(n, η), the LKJ(n, η) density's normaliser."""
    total = torch.zeros_like(eta)
    for k in range(1, n):
        total = total + 0.5 * k * math.log(math.pi) + torch.lgamma(eta + 0.5 * (n - 1 - k)) - torch.lgamma(
            eta + 0.5 * (n - 1))
    return total


def _onion_cholesky(n: int, eta: torch.Tensor, sample_shape, generator) -> torch.Tensor:
    """Cholesky factors of LKJ(n, η) draws, of shape sample_shape + η's shape + (n, n)."""
    shape = tuple(sample_shape) + eta.shape
    kw = dict(dtype=eta.dtype, device=eta.device)
    i = torch.arange(n, **kw)  # 0-based row
    a = (i / 2).expand(shape + (n,))
    b = (eta.unsqueeze(-1) + (n - 1 - i) / 2).expand(shape + (n,))
    g_a = _standard_gamma(a.clamp_min(0.5), generator)  # row 0 (a = 0) is replaced below
    g_b = _standard_gamma(b, generator)
    y = (g_a / (g_a + g_b)).unsqueeze(-1)
    u = torch.randn(shape + (n, n), generator=generator, **kw).tril(-1)
    u = u / u.norm(dim=-1, keepdim=True).clamp_min(torch.finfo(eta.dtype).tiny)
    w = y.sqrt() * u
    w[..., 0, :] = 0.0
    diag = (1.0 - (w**2).sum(-1)).clamp_min(torch.finfo(eta.dtype).tiny).sqrt()
    return w + torch.diag_embed(diag)


class LKJPrior(Prior):
    """LKJ(n, η) over correlation matrices."""

    def __init__(self, n: int, eta):
        super().__init__()
        self.n = int(n)
        self.register_buffer("eta", _buffer(eta))

    def log_prob(self, X: torch.Tensor) -> torch.Tensor:
        return (self.eta - 1.0) * torch.linalg.slogdet(X)[1] - _lkj_log_norm_const(self.n, self.eta)

    def sample(self, sample_shape=(), generator=None) -> torch.Tensor:
        L = _onion_cholesky(self.n, self.eta, sample_shape, generator)
        return L @ L.mT


class LKJCholeskyFactorPrior(LKJPrior):
    """LKJ(n, η) over the lower Cholesky factors of correlation matrices."""

    def log_prob(self, L: torch.Tensor) -> torch.Tensor:
        diag = torch.diagonal(L, dim1=-2, dim2=-1)
        i = torch.arange(1, self.n + 1, dtype=diag.dtype, device=diag.device)
        exponents = self.n - i + 2.0 * self.eta.unsqueeze(-1) - 2.0
        return (exponents * diag.clamp_min(1e-30).log()).sum(-1) - _lkj_log_norm_const(self.n, self.eta)

    def sample(self, sample_shape=(), generator=None) -> torch.Tensor:
        return _onion_cholesky(self.n, self.eta, sample_shape, generator)


class LKJCovariancePrior(Prior):
    """A covariance matrix Σ = D R D with R ~ LKJ(n, η) and the standard deviations D's
    diagonal independent draws of ``sd_prior``."""

    def __init__(self, n: int, eta, sd_prior: Prior):
        super().__init__()
        self.n = int(n)
        self.correlation_prior = LKJPrior(n, eta)
        self.sd_prior = sd_prior

    def log_prob(self, X: torch.Tensor) -> torch.Tensor:
        sd = torch.diagonal(X, dim1=-2, dim2=-1).sqrt()
        corr = X / (sd.unsqueeze(-1) * sd.unsqueeze(-2))
        return self.correlation_prior.log_prob(corr) + self.sd_prior.log_prob(sd).sum(-1)

    def sample(self, sample_shape=(), generator=None) -> torch.Tensor:
        corr = self.correlation_prior.sample(sample_shape, generator)
        sd = self.sd_prior.sample(tuple(sample_shape) + (self.n,), generator).reshape(corr.shape[:-2] + (self.n,))
        return corr * (sd.unsqueeze(-1) * sd.unsqueeze(-2))
