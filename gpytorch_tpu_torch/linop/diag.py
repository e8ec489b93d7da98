"""Diagonal operators.  Counterpart of ``gpytorch_tpu/linop/diag.py``: ``DiagLinearOperator``
diag(d) for d of shape batch + (n,), ``ConstantDiagLinearOperator`` c·I for c of shape
batch + (1,), and ``IdentityLinearOperator``.  Their log-determinants, inverse quadratic
forms, Cholesky factors and roots are closed forms at every size: no mBCG, whatever
``settings.max_cholesky_size`` says (the whitened KL's N(0, I) prior)."""

from __future__ import annotations

import torch

from .base import ClosedFormInvQuadLogdet, LinearOperator


class DiagLinearOperator(ClosedFormInvQuadLogdet, LinearOperator):
    """diag(d) with d of shape batch + (n,)."""

    def __init__(self, diag: torch.Tensor):
        self.diag = diag

    def _diag_values(self) -> torch.Tensor:
        return self.diag

    def _eig_lower_bound(self) -> torch.Tensor:
        return self.diag.amin(-1)  # the eigenvalues are the diagonal

    def _shape(self):
        d = self.diag.shape
        return tuple(d) + (d[-1],)

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device

    def _matmul(self, rhs):
        return self.diag.unsqueeze(-1) * rhs

    def _diagonal(self):
        return self.diag

    def to_dense(self):
        return torch.diag_embed(self.diag)

    def _get_rows(self, idx):
        diag = self.diag
        n = diag.shape[-1]
        idx = idx.expand(diag.shape[:-1] + idx.shape[-1:])
        onehot = (idx.unsqueeze(-1) == torch.arange(n, device=self.device)).to(self.dtype)
        return onehot * torch.take_along_dim(diag, idx, dim=-1).unsqueeze(-1)

    def _entries(self, rows, cols):
        return torch.where(rows == cols, self.diag[..., rows], torch.zeros((), dtype=self.dtype, device=self.device))

    def add_diagonal(self, diag):
        return DiagLinearOperator(self.diag + diag)

    def _inv_quad_cols(self, rhs):
        return (rhs * rhs / self.diag.unsqueeze(-1)).sum(-2)

    def logdet(self) -> torch.Tensor:
        return torch.log(self.diag).sum(-1)

    def cholesky(self, upper: bool = False) -> "DiagLinearOperator":
        return DiagLinearOperator(torch.sqrt(self.diag))

    def root_decomposition(self, method=None):
        from .root import RootLinearOperator

        return RootLinearOperator(torch.diag_embed(torch.sqrt(self.diag)))

    def _flatten(self):
        return (self.diag,), lambda ts: DiagLinearOperator(ts[0])

    def __add__(self, other):
        if isinstance(other, DiagLinearOperator):
            return DiagLinearOperator(self.diag + other._diag_values())
        if isinstance(other, LinearOperator):
            return other.add_diagonal(self.diag)
        return super().__add__(other)


class ConstantDiagLinearOperator(DiagLinearOperator):
    """c·I of size n, with c of shape batch + (1,)."""

    def __init__(self, value: torch.Tensor, diag_shape: int):
        self.value = value
        self._diag_shape = int(diag_shape)

    @property
    def diag(self) -> torch.Tensor:
        return self.value.expand(self.value.shape[:-1] + (self._diag_shape,))

    def _shape(self):
        n = self._diag_shape
        return tuple(self.value.shape[:-1]) + (n, n)

    def _eig_lower_bound(self) -> torch.Tensor:
        return self.value[..., 0]

    def _matmul(self, rhs):
        return self.value.unsqueeze(-1) * rhs

    def logdet(self) -> torch.Tensor:
        return self._diag_shape * torch.log(self.value[..., 0])

    def _flatten(self):
        n = self._diag_shape
        return (self.value,), lambda ts: ConstantDiagLinearOperator(ts[0], n)


class IdentityLinearOperator(ConstantDiagLinearOperator):
    """I of size n (``gpytorch_tpu/linop/diag.py:161``), with an optional batch shape: the
    data factor I_n of the multitask noise I_n ⊗ Σ_task."""

    def __init__(self, diag_shape: int, dtype=torch.float32, device=None, batch_shape=()):
        super().__init__(torch.ones(tuple(batch_shape) + (1,), dtype=dtype, device=device), diag_shape)

    def _is_known_psd(self) -> bool:
        return True

    def _matmul(self, rhs):
        return rhs.expand(torch.broadcast_shapes(self.batch_shape + rhs.shape[-2:], rhs.shape))

    def logdet(self) -> torch.Tensor:
        return torch.zeros(self.batch_shape, dtype=self.dtype, device=self.device)

    def _flatten(self):
        n, batch, value = self._diag_shape, self.batch_shape, self.value
        return (), lambda ts: IdentityLinearOperator(n, value.dtype, value.device, batch)
