"""Composition operators.  Counterpart of ``gpytorch_tpu/linop/composition.py``: sums
and constant multiples (what the LOVE predictive covariance K** − (K*x R)(K*x R)ᵀ and the
multitask marginal K_data ⊗ K_task + (I ⊗ D + σ²I) are built from), products, row and
column concatenation, a batch repeat, and the masked operator of the NaN policy "mask"."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from .base import LinearOperator, to_linear_operator


def _flatten_all(ops):
    """The tensors of several operators and a function that rebuilds the list."""
    parts = [op._flatten() for op in ops]
    counts = [len(ts) for ts, _ in parts]

    def rebuild(tensors):
        out, start = [], 0
        for (_, rb), c in zip(parts, counts):
            out.append(rb(tensors[start:start + c]))
            start += c
        return out

    return tuple(t for ts, _ in parts for t in ts), rebuild


class SumLinearOperator(LinearOperator):
    def __init__(self, *ops):
        flat = []
        for op in ops:
            flat.extend(op.ops if isinstance(op, SumLinearOperator) else [to_linear_operator(op)])
        self.ops = tuple(flat)

    def _shape(self):
        return tuple(torch.broadcast_shapes(*[op.shape for op in self.ops]))

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

    def _matmul_grad_only(self, rhs):
        return self._sum(lambda op: op._matmul_grad_only(rhs))

    def _flatten(self):
        tensors, rebuild = _flatten_all(self.ops)
        return tensors, lambda ts: SumLinearOperator(*rebuild(ts))

    def _diagonal(self):
        return self._sum(lambda op: op._diagonal())

    def _get_rows(self, idx):
        return self._sum(lambda op: op._get_rows(idx))

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

    def _matmul_grad_only(self, rhs):
        return self.constant * self.base._matmul_grad_only(rhs)

    def _flatten(self):
        tb, rb = self.base._flatten()
        if not torch.is_tensor(self.constant):
            constant = self.constant
            return tb, lambda ts: ConstantMulLinearOperator(rb(ts), constant)
        nb = len(tb)
        return tb + (self.constant,), lambda ts: ConstantMulLinearOperator(rb(ts[:nb]), ts[nb])

    def _diagonal(self):
        return self.constant * self.base._diagonal()

    def to_dense(self):
        return self.constant * self.base.to_dense()

    def evaluate_kernel(self):
        return ConstantMulLinearOperator(self.base.evaluate_kernel(), self.constant)


class MatmulLinearOperator(LinearOperator):
    """left · right."""

    def __init__(self, left, right):
        self.left = to_linear_operator(left)
        self.right = to_linear_operator(right)

    def _shape(self):
        batch = torch.broadcast_shapes(self.left.batch_shape, self.right.batch_shape)
        return tuple(batch) + (self.left.shape[-2], self.right.shape[-1])

    @property
    def dtype(self):
        return self.left.dtype

    @property
    def device(self):
        return self.left.device

    def _matmul(self, rhs):
        return self.left._matmul(self.right._matmul(rhs))

    def _flatten(self):
        tensors, rebuild = _flatten_all((self.left, self.right))
        return tensors, lambda ts: MatmulLinearOperator(*rebuild(ts))

    def _diagonal(self):
        return torch.einsum("...ij,...ji->...i", self.left.to_dense(), self.right.to_dense())

    def to_dense(self):
        return self.left.to_dense() @ self.right.to_dense()


class CatLinearOperator(LinearOperator):
    """Operators joined along their rows (``dim=-2``) or columns (``dim=-1``)."""

    def __init__(self, ops: Sequence[LinearOperator], dim: int = -2):
        if dim not in (-1, -2):
            raise ValueError("CatLinearOperator supports dim in {-1, -2}")
        self.ops = tuple(to_linear_operator(op) for op in ops)
        self.dim = int(dim)

    def _shape(self):
        shape = list(self.ops[0].shape)
        shape[self.dim] = sum(op.shape[self.dim] for op in self.ops)
        return tuple(shape)

    @property
    def dtype(self):
        return self.ops[0].dtype

    @property
    def device(self):
        return self.ops[0].device

    def _matmul(self, rhs):
        if self.dim == -2:
            return torch.cat([op._matmul(rhs) for op in self.ops], dim=-2)
        out, start = None, 0
        for op in self.ops:
            part = op._matmul(rhs[..., start:start + op.shape[-1], :])
            out = part if out is None else out + part
            start += op.shape[-1]
        return out

    def _flatten(self):
        tensors, rebuild = _flatten_all(self.ops)
        dim = self.dim
        return tensors, lambda ts: CatLinearOperator(rebuild(ts), dim)

    def to_dense(self):
        return torch.cat([op.to_dense() for op in self.ops], dim=self.dim)


class BatchRepeatLinearOperator(LinearOperator):
    """``base`` repeated over the batch shape ``batch_repeat``.  A product of an unbatched base
    with a batched right-hand side (…, n, t) is one product with the batch folded into the
    columns, (n, b·t): for a lazy kernel operator one fused K·V launch (and one fused backward)
    for the whole batch."""

    def __init__(self, base: LinearOperator, batch_repeat: Tuple[int, ...]):
        self.base = base
        self.batch_repeat = tuple(int(b) for b in batch_repeat)

    def _shape(self):
        return tuple(torch.broadcast_shapes(self.base.batch_shape, self.batch_repeat)) + self.base.shape[-2:]

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def _expand(self, x: torch.Tensor, tail: int) -> torch.Tensor:
        return x.expand(self.batch_shape + x.shape[-tail:])

    def _folded(self, product, rhs: torch.Tensor) -> torch.Tensor:
        if self.base.batch_shape or rhs.ndim <= 2:
            return self._expand(product(rhs), 2)
        batch, (n, t) = rhs.shape[:-2], rhs.shape[-2:]
        b = math.prod(batch)
        out = product(rhs.reshape(b, n, t).permute(1, 0, 2).reshape(n, b * t))
        out = out.reshape(out.shape[-2], b, t).permute(1, 0, 2).reshape(batch + (out.shape[-2], t))
        return self._expand(out, 2)

    def _matmul(self, rhs):
        return self._folded(self.base._matmul, rhs)

    def _matmul_grad_only(self, rhs):
        return self._folded(self.base._matmul_grad_only, rhs)

    def _flatten(self):
        tb, rb = self.base._flatten()
        repeat = self.batch_repeat
        return tb, lambda ts: BatchRepeatLinearOperator(rb(ts), repeat)

    def _diagonal(self):
        return self._expand(self.base._diagonal(), 1)

    def to_dense(self):
        return self._expand(self.base.to_dense(), 2)

    def evaluate_kernel(self):
        return BatchRepeatLinearOperator(self.base.evaluate_kernel(), self.batch_repeat)


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
