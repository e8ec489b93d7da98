"""InterpolatedLinearOperator — W_l K W_rᵀ, the KISS-GP (SKI) covariance.

Counterpart of ``gpytorch_tpu/linop/interpolated.py``.  K is the grid covariance K_UU
(m × m: Toeplitz, Kronecker or dense, symmetric) and W_l, W_r the sparse interpolation
matrices held as (indices, values) of shape (n, q).  A product is a scatter-add Wᵀ·, a
product with K and a gather W·.  Three reads never form an n × n or m × m matrix, where the
JAX package's do (it densifies through ``to_dense``):

* ``_diagonal``: diag[i] = Σ_{q,p} w_l[i,q] K[a_iq, b_ip] w_r[i,p], from the q × q entries
  of K that each row touches (``_entries``: c[|a − b|] for a Toeplitz K, a product of
  those for a Kronecker one);
* ``_get_rows`` (what pivoted Cholesky reads): W_l[idx] K W_rᵀ = (W_r K W_l[idx]ᵀ)ᵀ, one
  product of K with idx.numel() columns;
* ``to_dense``: through an identity on the smaller side, n_l or n_r.

Slicing slices the interpolation, never the base.  Not known to be PSD: an added
diagonal gives the Lanczos inverse root no Ritz floor, as in the JAX package.

Batched interpolation (…, n, q) or a batched base broadcast to one batch
(``gpytorch_tpu/linop/interpolated.py:38-41``): one matrix per element, as
``last_dim_is_batch`` builds them (one interpolation a dimension).  Its dense matrix is
formed a block of rows at a time (``_ROWS``), so that the gather never holds more than a
block's q × n values.
"""

from __future__ import annotations

import torch

from ..ops.interp import dense_t, left_interp, left_t_interp
from .base import LinearOperator, to_linear_operator, two_slices

# rows of W per block of the dense product W (K Wᵀ)
_ROWS = 2048


def _left_interp_rows(indices, values, rhs):
    """left_interp by blocks of _ROWS rows of W: the same rows, a block's gather at a time."""
    n = indices.shape[-2]
    if n <= _ROWS:
        return left_interp(indices, values, rhs)
    return torch.cat([left_interp(indices[..., i:i + _ROWS, :], values[..., i:i + _ROWS, :], rhs)
                      for i in range(0, n, _ROWS)], -2)


class InterpolatedLinearOperator(LinearOperator):
    def __init__(self, base: LinearOperator, left_interp_indices: torch.Tensor, left_interp_values: torch.Tensor,
                 right_interp_indices=None, right_interp_values=None):
        self.base = to_linear_operator(base)
        self.left_interp_indices = left_interp_indices
        self.left_interp_values = left_interp_values
        self.right_interp_indices = left_interp_indices if right_interp_indices is None else right_interp_indices
        self.right_interp_values = left_interp_values if right_interp_values is None else right_interp_values

    def _shape(self):
        batch = torch.broadcast_shapes(self.base.batch_shape, self.left_interp_indices.shape[:-2],
                                       self.right_interp_indices.shape[:-2])
        return tuple(batch) + (self.left_interp_indices.shape[-2], self.right_interp_indices.shape[-2])

    @property
    def dtype(self):
        return self.left_interp_values.dtype

    @property
    def device(self):
        return self.left_interp_values.device

    def _symmetric_interp(self) -> bool:
        return self.right_interp_indices is self.left_interp_indices and self.right_interp_values is self.left_interp_values

    def _matmul(self, rhs):
        m = self.base.shape[-1]
        tmp = left_t_interp(self.right_interp_indices, self.right_interp_values, rhs, m)
        return left_interp(self.left_interp_indices, self.left_interp_values, self.base.matmul(tmp))

    def _flatten(self):
        tb, rb = self.base._flatten()
        nb = len(tb)
        if self._symmetric_interp():
            return tb + (self.left_interp_indices, self.left_interp_values), \
                lambda ts: InterpolatedLinearOperator(rb(ts[:nb]), *ts[nb:])
        interp = (self.left_interp_indices, self.left_interp_values, self.right_interp_indices, self.right_interp_values)
        return tb + interp, lambda ts: InterpolatedLinearOperator(rb(ts[:nb]), *ts[nb:])

    def _diagonal(self):
        li, ri = self.left_interp_indices, self.right_interp_indices
        batch = self.batch_shape
        if not batch:
            blocks = self.base._entries(li.unsqueeze(-1), ri.unsqueeze(-2))  # (n, q, q)
            return torch.einsum("nq,nqp,np->n", self.left_interp_values, blocks, self.right_interp_values)
        # a batch: each element's q × q entries of its dense base
        m = self.base.shape[-1]
        flat = (li.unsqueeze(-1) * m + ri.unsqueeze(-2)).expand(batch + li.shape[-2:] + ri.shape[-1:])
        dense = self.base.to_dense().expand(batch + (m, m)).reshape(batch + (m * m,))
        blocks = torch.take_along_dim(dense, flat.reshape(batch + (-1,)), -1).reshape(flat.shape)
        return torch.einsum("...nq,...nqp,...np->...n", self.left_interp_values, blocks, self.right_interp_values)

    def _get_rows(self, idx):
        """Rows idx (k,), or batch + (k,) per element, of W_l K W_rᵀ."""
        m = self.base.shape[-1]
        k = idx.shape[-1]
        eye = torch.eye(k, dtype=self.dtype, device=self.device)
        batch = self.batch_shape
        if batch:
            pick = idx.expand(batch + (k,)).unsqueeze(-1)
            rows_i, rows_v = (torch.take_along_dim(t.expand(batch + t.shape[-2:]), pick, -2)
                              for t in (self.left_interp_indices, self.left_interp_values))
        else:
            rows_i, rows_v = self.left_interp_indices[idx], self.left_interp_values[idx]
        wt = left_t_interp(rows_i, rows_v, eye, m)  # (…, m, k)
        return left_interp(self.right_interp_indices, self.right_interp_values, self.base.matmul(wt)).mT

    def to_dense(self):
        m = self.base.shape[-1]
        n_l, n_r = self.shape[-2:]
        if n_r <= n_l:
            wt = dense_t(self.right_interp_indices, self.right_interp_values, m)
            return _left_interp_rows(self.left_interp_indices, self.left_interp_values, self.base.matmul(wt))
        wt = dense_t(self.left_interp_indices, self.left_interp_values, m)
        return _left_interp_rows(self.right_interp_indices, self.right_interp_values, self.base.matmul(wt)).mT

    def __getitem__(self, index):
        """``op[rows, cols]`` or ``op[..., rows, cols]`` with two slices: the interpolation
        rows, not the base; any other index from the dense matrix, as the JAX package
        indexes it (``gpytorch_tpu/linop/interpolated.py:95-105``)."""
        if not two_slices(index):
            return super().__getitem__(index)
        row_ix, col_ix = index[-2:]
        return InterpolatedLinearOperator(self.base, self.left_interp_indices[..., row_ix, :],
                                          self.left_interp_values[..., row_ix, :],
                                          self.right_interp_indices[..., col_ix, :],
                                          self.right_interp_values[..., col_ix, :])
