"""Sum and constant-multiple operators — what the LOVE predictive covariance
K** − (K*x R)(K*x R)ᵀ is built from — and the masked operator of the NaN policy "mask".
Counterpart of ``SumLinearOperator``, ``ConstantMulLinearOperator`` and
``MaskedLinearOperator`` in ``gpytorch_tpu/linop/composition.py``."""

from __future__ import annotations

import torch

from .base import LinearOperator, to_linear_operator


class SumLinearOperator(LinearOperator):
    def __init__(self, *ops):
        flat = []
        for op in ops:
            flat.extend(op.ops if isinstance(op, SumLinearOperator) else [to_linear_operator(op)])
        self.ops = tuple(flat)

    def _shape(self):
        return self.ops[0].shape

    @property
    def dtype(self):
        return self.ops[0].dtype

    @property
    def device(self):
        return self.ops[0].device

    def _sum(self, fn):
        out = fn(self.ops[0])
        for op in self.ops[1:]:
            out = out + fn(op)
        return out

    def _matmul(self, rhs):
        return self._sum(lambda op: op._matmul(rhs))

    def _diagonal(self):
        return self._sum(lambda op: op._diagonal())

    def to_dense(self):
        return self._sum(lambda op: op.to_dense())

    def evaluate_kernel(self):
        return SumLinearOperator(*[op.evaluate_kernel() for op in self.ops])


class ConstantMulLinearOperator(LinearOperator):
    def __init__(self, base: LinearOperator, constant):
        self.base = base
        self.constant = constant

    def _shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def _matmul(self, rhs):
        return self.constant * self.base._matmul(rhs)

    def _diagonal(self):
        return self.constant * self.base._diagonal()

    def to_dense(self):
        return self.constant * self.base.to_dense()

    def evaluate_kernel(self):
        return ConstantMulLinearOperator(self.base.evaluate_kernel(), self.constant)


class MaskedLinearOperator(LinearOperator):
    """K̃ = m mᵀ ⊙ K + diag(1 − m) for a boolean mask m over the rows and columns of a
    square operator K, with a static shape: the counterpart of
    ``gpytorch_tpu/linop/composition.py::MaskedLinearOperator``.  log|K̃| = log|K[obs, obs]|
    and ỹᵀK̃⁻¹ỹ = y_obsᵀ K_obs⁻¹ y_obs for ỹ = m ⊙ y, so the masked MLL and mean cache are
    exact without dropping rows.  The mask enters ``_flatten`` as a tensor that carries no
    gradient.  As in the JAX package it has no preconditioner: CG on it runs
    unpreconditioned."""

    def __init__(self, base: LinearOperator, mask: torch.Tensor):
        self.base = base
        self.mask = torch.as_tensor(mask, dtype=torch.bool, device=base.device)

    def _shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def _column_mask(self, dtype) -> torch.Tensor:
        return self.mask.to(dtype).unsqueeze(-1)

    def _matmul(self, rhs):
        m = self._column_mask(rhs.dtype)
        return self.base._matmul(rhs * m) * m + rhs * (1.0 - m)

    def _matmul_grad_only(self, rhs):
        m = self._column_mask(rhs.dtype)
        return self.base._matmul_grad_only(rhs * m) * m + rhs * (1.0 - m)

    def _flatten(self):
        tb, rb = self.base._flatten()
        nb = len(tb)
        return tb + (self.mask,), lambda ts: MaskedLinearOperator(rb(ts[:nb]), ts[nb])

    def _diagonal(self):
        m = self.mask.to(self.dtype)
        return self.base._diagonal() * m + (1.0 - m)

    def to_dense(self):
        m = self.mask.to(self.dtype)
        return self.base.to_dense() * (m.unsqueeze(-1) * m) + torch.diag_embed(1.0 - m)

    def evaluate_kernel(self):
        return MaskedLinearOperator(self.base.evaluate_kernel(), self.mask)
