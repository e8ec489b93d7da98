"""Symmetric Toeplitz products through the FFT of a circulant embedding.

Counterpart of ``gpytorch_tpu/ops/toeplitz.py``.  T (first column c, n × n) embeds in the
2n circulant with first column [c₀ … c_{n−1}, 0, c_{n−1} … c₁], so T·v is the first n
rows of two real FFTs of length 2n and their product: O(n log n) and no n × n matrix.
Differentiable in the column and the right-hand side through ``torch.fft``.
"""

from __future__ import annotations

import torch


def sym_toeplitz_matmul(column: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """T(column)·rhs for T symmetric Toeplitz: column (…, n), rhs (…, n, k) or (n,), the
    batch dimensions broadcast."""
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs.unsqueeze(-1)
    n = column.shape[-1]
    circ = torch.cat([column, column.new_zeros(column.shape[:-1] + (1,)), column[..., 1:].flip(-1)], -1)
    fft_c = torch.fft.rfft(circ)
    fft_rhs = torch.fft.rfft(torch.cat([rhs, torch.zeros_like(rhs)], -2), dim=-2)
    out = torch.fft.irfft(fft_c.unsqueeze(-1) * fft_rhs, n=2 * n, dim=-2)[..., :n, :].to(rhs.dtype)
    return out.squeeze(-1) if squeeze else out
