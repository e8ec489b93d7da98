"""Sparse interpolation products for KISS-GP (SKI).

Counterpart of ``gpytorch_tpu/ops/interp.py``.  The interpolation matrix W (n × m, q = 4^d
nonzeros a row) is held as (indices, values), both (n, q): W·V is a gather and Wᵀ·V a
scatter-add.  The scatter-add is a segment sum over the indices sorted once a call
(``torch.argsort`` stable, ``torch.segment_reduce``): each output row sums its terms in
the order the rows of W hold them, on every device, so that two runs of Wᵀ·V on the card
agree bit for bit (``index_add_`` on CUDA adds with atomics, in no fixed order).  Both are
plain PyTorch: the JAX package's counterparts are XLA gathers and segment sums, no Pallas
kernel.

Batched indices, values or right-hand sides (…, n, q) and (…, m, k) broadcast to one batch,
flattened: the gather indexes each element's rows, and the scatter-add offsets each
element's indices by its place in the batch, so that one segment sum serves the batch and
an unbatched call runs the same operations as before.  ``dense_t`` forms Wᵀ itself,
(…, m, n), by the same segment sum over one entry a nonzero.
"""

from __future__ import annotations

import torch


def segment_sum(index: torch.Tensor, src: torch.Tensor, size: int) -> torch.Tensor:
    """out[i] = Σ_{j: index[j] = i} src[j] for i < ``size``, summed in the order of j.

    index: (r,) int; src: (r, k) → (size, k)."""
    order = torch.argsort(index, stable=True)
    lengths = torch.bincount(index, minlength=size)
    return torch.segment_reduce(src[order], "sum", lengths=lengths, axis=0)


def _flat_batch(indices, values, rhs):
    """(batch, indices, values, rhs) with the three broadcast to one batch, flattened."""
    batch = tuple(torch.broadcast_shapes(indices.shape[:-2], values.shape[:-2], rhs.shape[:-2]))

    def flat(t):
        return t.expand(batch + t.shape[-2:]).reshape((-1,) + t.shape[-2:])

    return batch, flat(indices), flat(values), flat(rhs)


def left_interp(indices: torch.Tensor, values: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """W·rhs with W[i, indices[i, q]] = values[i, q]: (…, n, q), (…, n, q), (…, m, k) → (…, n, k)."""
    if rhs.ndim == 1:
        return left_interp(indices, values, rhs.unsqueeze(-1)).squeeze(-1)
    if indices.ndim == values.ndim == rhs.ndim == 2:
        return (rhs[indices] * values.unsqueeze(-1)).sum(-2)
    batch, indices, values, rhs = _flat_batch(indices, values, rhs)
    element = torch.arange(rhs.shape[0], device=rhs.device).reshape(-1, 1, 1)
    out = (rhs[element, indices] * values.unsqueeze(-1)).sum(-2)
    return out.reshape(batch + out.shape[-2:])


def left_t_interp(indices: torch.Tensor, values: torch.Tensor, rhs: torch.Tensor, output_dim: int) -> torch.Tensor:
    """Wᵀ·rhs: (…, n, q), (…, n, q), (…, n, k) → (…, output_dim, k), a deterministic segment sum."""
    if rhs.ndim == 1:
        return left_t_interp(indices, values, rhs.unsqueeze(-1), output_dim).squeeze(-1)
    if indices.ndim == values.ndim == rhs.ndim == 2:
        n, q = indices.shape
        contrib = (values.unsqueeze(-1) * rhs.unsqueeze(-2)).reshape(n * q, rhs.shape[-1])
        return segment_sum(indices.reshape(-1), contrib, output_dim)
    batch, indices, values, rhs = _flat_batch(indices, values, rhs)
    b, n, q = indices.shape
    k = rhs.shape[-1]
    contrib = (values.unsqueeze(-1) * rhs.unsqueeze(-2)).reshape(b * n * q, k)
    offset = (torch.arange(b, device=indices.device) * output_dim).reshape(-1, 1, 1)
    out = segment_sum((indices + offset).reshape(-1), contrib, b * output_dim)
    return out.reshape(batch + (output_dim, k))


def dense_t(indices: torch.Tensor, values: torch.Tensor, output_dim: int) -> torch.Tensor:
    """Wᵀ as a dense (…, output_dim, n) matrix: ``left_t_interp`` of the identity, without
    the n × n identity (each entry of Wᵀ is one value: a row's indices are distinct)."""
    batch = tuple(torch.broadcast_shapes(indices.shape[:-2], values.shape[:-2]))
    n, q = indices.shape[-2:]
    indices = indices.expand(batch + (n, q)).reshape(-1, n, q)
    values = values.expand(batch + (n, q)).reshape(-1, q)
    b = indices.shape[0]
    key = indices * n + torch.arange(n, device=indices.device).unsqueeze(-1)
    key = key + (torch.arange(b, device=indices.device) * (output_dim * n)).reshape(-1, 1, 1)
    out = segment_sum(key.reshape(-1), values.reshape(-1, 1), b * output_dim * n)
    return out.reshape(batch + (output_dim, n))
