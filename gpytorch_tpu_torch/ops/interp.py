"""Sparse interpolation products for KISS-GP (SKI).

Counterpart of ``gpytorch_tpu/ops/interp.py``.  The interpolation matrix W (n × m, q = 4^d
nonzeros a row) is held as (indices, values), both (n, q): W·V is a gather and Wᵀ·V a
scatter-add.  The scatter-add is a segment sum over the indices sorted once a call
(``torch.argsort`` stable, ``torch.segment_reduce``): each output row sums its terms in
the order the rows of W hold them, on every device, so that two runs of Wᵀ·V on the card
agree bit for bit (``index_add_`` on CUDA adds with atomics, in no fixed order).  Both are
plain PyTorch: the JAX package's counterparts are XLA gathers and segment sums, no Pallas
kernel.
"""

from __future__ import annotations

import torch


def segment_sum(index: torch.Tensor, src: torch.Tensor, size: int) -> torch.Tensor:
    """out[i] = Σ_{j: index[j] = i} src[j] for i < ``size``, summed in the order of j.

    index: (r,) int; src: (r, k) → (size, k)."""
    order = torch.argsort(index, stable=True)
    lengths = torch.bincount(index, minlength=size)
    return torch.segment_reduce(src[order], "sum", lengths=lengths, axis=0)


def left_interp(indices: torch.Tensor, values: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """W·rhs with W[i, indices[i, q]] = values[i, q]: (n, q), (n, q), (m, k) → (n, k)."""
    if rhs.ndim == 1:
        return left_interp(indices, values, rhs.unsqueeze(-1)).squeeze(-1)
    return (rhs[indices] * values.unsqueeze(-1)).sum(-2)


def left_t_interp(indices: torch.Tensor, values: torch.Tensor, rhs: torch.Tensor, output_dim: int) -> torch.Tensor:
    """Wᵀ·rhs: (n, q), (n, q), (n, k) → (output_dim, k), a deterministic segment sum."""
    if rhs.ndim == 1:
        return left_t_interp(indices, values, rhs.unsqueeze(-1), output_dim).squeeze(-1)
    n, q = indices.shape
    contrib = (values.unsqueeze(-1) * rhs.unsqueeze(-2)).reshape(n * q, rhs.shape[-1])
    return segment_sum(indices.reshape(-1), contrib, output_dim)
