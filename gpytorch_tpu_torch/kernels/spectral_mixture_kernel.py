"""SpectralMixtureKernel: k(τ) = Σ_q w_q Π_d exp(−2π² τ_d² v_qd) cos(2π τ_d μ_qd).

Counterpart of ``gpytorch_tpu/kernels/spectral_mixture_kernel.py`` (Wilson & Adams, 2013).
Weights (batch + (Q,)), means and scales (batch + (Q, 1, d)) are raw parameters behind
``Positive``, ``GreaterThan(1e-6)`` and ``Positive``.  No fused product, in either package:
above ``max_eager_kernel_size``² the lazy operator streams K·V by blocks of rows, each block
of Q × rows × m values.

``initialize_from_data`` and ``initialize_from_data_empspect`` are the JAX package's numpy
code, with ``RandomState(0)``: the same data give the same parameters in both packages.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..constraints import GreaterThan, Positive
from .kernel import Kernel
from .stationary import _last_dim_batch


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class SpectralMixtureKernel(Kernel):
    def __init__(self, num_mixtures: Optional[int] = None, ard_num_dims: int = 1, batch_shape=(),
                 mixture_scales_constraint=None, mixture_means_constraint=None, mixture_weights_constraint=None,
                 **kwargs):
        if num_mixtures is None:
            raise RuntimeError("num_mixtures is a required argument")
        super().__init__(ard_num_dims=ard_num_dims, batch_shape=batch_shape, **kwargs)
        self.num_mixtures = int(num_mixtures)
        q, d = self.num_mixtures, int(ard_num_dims)
        for name, shape, constraint in (("weights", (q,), mixture_weights_constraint or Positive()),
                                        ("means", (q, 1, d), mixture_means_constraint or GreaterThan(1e-6)),
                                        ("scales", (q, 1, d), mixture_scales_constraint or Positive())):
            self.register_parameter(f"raw_mixture_{name}", torch.nn.Parameter(torch.zeros(self.batch_shape + shape)))
            self.register_constraint(f"raw_mixture_{name}", constraint)

    @property
    def mixture_weights(self) -> torch.Tensor:
        return self._constrained("raw_mixture_weights")

    @mixture_weights.setter
    def mixture_weights(self, value) -> None:
        self._set_constrained("raw_mixture_weights", value)

    @property
    def mixture_means(self) -> torch.Tensor:
        return self._constrained("raw_mixture_means")

    @mixture_means.setter
    def mixture_means(self, value) -> None:
        self._set_constrained("raw_mixture_means", value)

    @property
    def mixture_scales(self) -> torch.Tensor:
        return self._constrained("raw_mixture_scales")

    @mixture_scales.setter
    def mixture_scales(self, value) -> None:
        self._set_constrained("raw_mixture_scales", value)

    def hypers(self):
        return {"mixture_weights": self.mixture_weights, "mixture_means": self.mixture_means,
                "mixture_scales": self.mixture_scales}

    def initialize_from_data_empspect(self, train_x, train_y) -> "SpectralMixtureKernel":
        """Means drawn from the empirical spectrum of ``train_y`` (its periodogram's CDF at
        Q uniform draws), scales 1 / the input range, weights std(y) / Q."""
        train_x, train_y = _numpy(train_x), _numpy(train_y)
        if train_x.ndim == 1:
            train_x = train_x[:, None]
        N = train_x.shape[-2]
        emp_spect = np.abs(np.fft.rfft(train_y, axis=-1)) ** 2 / N
        M = math.floor(N / 2)
        freq1 = np.arange(M + 1)
        freq2 = np.arange(0, M) if N % 2 == 0 else np.arange(0, M + 1)
        freqs = (np.concatenate([freq1, freq2]) / N)[: emp_spect.shape[-1]]
        spect_cdf = np.cumsum(emp_spect, axis=-1) / emp_spect.sum(-1, keepdims=True)
        a = np.random.RandomState(0).rand(self.num_mixtures, 1)
        idx = np.searchsorted(spect_cdf.reshape(-1), a.reshape(-1)).clip(0, len(freqs) - 1)
        means = freqs[idx].reshape(self.num_mixtures, 1, 1)
        self.mixture_means = np.broadcast_to(means, (self.num_mixtures, 1, train_x.shape[-1])).copy()
        self.mixture_scales = (1.0 / np.abs(train_x.max(0) - train_x.min(0)))[None, None, :]
        self.mixture_weights = float(train_y.std() / self.num_mixtures)
        return self

    def initialize_from_data(self, train_x, train_y) -> "SpectralMixtureKernel":
        """Means uniform on [0, 1 / (2 × the smallest input spacing)), scales |N(0, 1)| /
        the input range (floored at 1e-6), weights std(y) / Q."""
        train_x = _numpy(train_x)
        if train_x.ndim == 1:
            train_x = train_x[:, None]
        train_x_sort = np.sort(train_x, axis=-2)
        max_dist = train_x_sort[..., -1, :] - train_x_sort[..., 0, :]
        dists = np.diff(train_x_sort, axis=-2)
        dists = np.where(dists == 0, np.nan, dists)
        min_dist = np.nanmin(np.abs(dists), axis=-2)
        min_dist = np.where(np.isnan(min_dist), 1.0, min_dist)
        rng = np.random.RandomState(0)
        d = train_x.shape[-1]
        means = rng.rand(self.num_mixtures, 1, d) / (2.0 * min_dist)
        scales = np.abs(rng.randn(self.num_mixtures, 1, d) / (max_dist + 1e-12))
        self.mixture_means = means
        self.mixture_scales = np.maximum(scales, 1e-6)
        self.mixture_weights = float(_numpy(train_y).std()) / self.num_mixtures
        return self

    def evaluate(self, hypers, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        x1, x2 = _last_dim_batch(x1, x2, last_dim_is_batch)
        means, scales = hypers["mixture_means"], hypers["mixture_scales"]  # batch + (Q, 1, d)
        weights = hypers["mixture_weights"]  # batch + (Q,)
        if diag:
            tau = (x1 - x2).unsqueeze(-3)  # (…, 1, n, d)
        else:
            tau = (x1.unsqueeze(-2) - x2.unsqueeze(-3)).unsqueeze(-4)  # (…, 1, n, m, d)
            means, scales = means.unsqueeze(-3), scales.unsqueeze(-3)  # batch + (Q, 1, 1, d)
        comp = torch.prod(torch.exp(-2.0 * math.pi**2 * tau**2 * scales**2) * torch.cos(2.0 * math.pi * tau * means),
                          dim=-1)  # (…, Q, n[, m])
        return torch.einsum("...q,...qn->...n" if diag else "...q,...qnm->...nm", weights, comp)
