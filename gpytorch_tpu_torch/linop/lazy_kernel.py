"""LazyEvaluatedKernelOperator — defers kernel evaluation until a solver asks for it.

Counterpart of ``gpytorch_tpu/linop/lazy_kernel.py``.  Holds (kernel, x1, x2), the kernel's
hyperparameter tensors and an explicit ``symmetric`` flag (the JAX package keys symmetry
on ``x1 is x2``).  Slicing slices the inputs, so the joint train/test covariance never
rebuilds K(train, train) at test time; on inputs joined by ``join_rows`` a slice that is
one part takes that part itself, so that K(test, train) carries no autograd history on
its training side when the training inputs need no gradient.  Products with a kernel too
large to evaluate densely go to the fused kernel products (``ops/fused_kernels.py``,
``ops/periodic_kernels.py``): the plain streamed versions for CPU tensors, the CUDA
kernels for CUDA tensors.  A kernel that returns a structured operator
(``returns_lazy_structure``: the grid kernels, whose KISS-GP operator has closed-form
products) is always evaluated, whatever its size, and reads, products and rows go to that
operator (``gpytorch_tpu/linop/lazy_kernel.py:55-103``).

With ``last_dim_is_batch`` the operator holds one matrix per input dimension, the
dimensions a batch dimension after the others (``gpytorch_tpu/linop/lazy_kernel.py:41-48``),
and is always evaluated densely: the fused products take rows of inputs, not single
dimensions (``:95-98``).

A batched kernel (hyperparameters of shape batch + …) or batched inputs give a batched
operator.  Its fused products take one launch per batch element, each with its own centre,
lengthscale and outputscale, as the JAX package maps its Pallas kernels over the batch
(``jax.lax.map``, ``gpytorch_tpu/linop/lazy_kernel.py:128-190``).  A kernel with no fused
product, or a right-hand side whose batch shape is not the operator's, is streamed by
blocks of rows (``_matmul_chunked``).  A multitask kernel has ``num_outputs_per_input``
rows per input.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .. import settings
from .base import DenseLinearOperator, LinearOperator, to_linear_operator, two_slices

# rows of x1 per block of the streamed product (``gpytorch_tpu/linop/lazy_kernel.py:24``)
_CHUNK = 4096


def join_rows(*parts: torch.Tensor) -> torch.Tensor:
    """``torch.cat(parts, dim=-2)``, remembering where each part lies: a lazy kernel
    operator built on the result and sliced to exactly one part's rows takes that part
    itself, with its own autograd history and no other.  A slice of the plain
    concatenation would require grad as soon as any part does."""
    joined = torch.cat(parts, dim=-2)
    bounds, start = [], 0
    for part in parts:
        bounds.append((start, start + part.shape[-2], part))
        start += part.shape[-2]
    joined._joined_parts = tuple(bounds)
    return joined


def _rows(x: torch.Tensor, ix: slice) -> torch.Tensor:
    """x[..., ix, :] for a slice of rows: the part itself where x was joined by
    ``join_rows`` and ix is exactly one part's rows."""
    span = ix.indices(x.shape[-2])
    for start, stop, part in getattr(x, "_joined_parts", ()):
        if span == (start, stop, 1):
            return part
    return x[..., ix, :]


def _per_element(t: torch.Tensor, batch, tail: int) -> torch.Tensor:
    """t broadcast to ``batch`` + its last ``tail`` dims, the batch flattened into one."""
    return t.expand(tuple(batch) + t.shape[t.ndim - tail:]).reshape((math.prod(batch),) + t.shape[t.ndim - tail:])


class LazyEvaluatedKernelOperator(LinearOperator):
    def __init__(self, kernel, x1: torch.Tensor, x2: torch.Tensor, symmetric: bool = False,
                 hypers: Optional[Dict[str, torch.Tensor]] = None, last_dim_is_batch: bool = False):
        self.kernel = kernel
        self.x1 = x1
        self.x2 = x2
        self.symmetric = bool(symmetric)
        self.last_dim_is_batch = bool(last_dim_is_batch)
        # the kernel's hyperparameters as tensors, read once: every evaluation and product
        # goes through them, so an operator rebuilt from copies differentiates (_flatten)
        self.hypers = kernel.hypers() if hypers is None else dict(hypers)

    def _is_known_psd(self) -> bool:
        # K(X, X) of a valid kernel is PSD; a cross-covariance K(X, Z) is not
        return self.symmetric

    def _num_outputs(self) -> int:
        return self.kernel.num_outputs_per_input(self.x1, self.x2)

    def _shape(self):
        num = self._num_outputs()
        batch = torch.broadcast_shapes(self.x1.shape[:-2], self.x2.shape[:-2], tuple(self.kernel.batch_shape))
        if self.last_dim_is_batch:
            batch = tuple(batch) + (self.x1.shape[-1],)
        return tuple(batch) + (self.x1.shape[-2] * num, self.x2.shape[-2] * num)

    @property
    def dtype(self):
        return self.x1.dtype

    @property
    def device(self):
        return self.x1.device

    def _flatten(self):
        names = list(self.hypers)
        xs = (self.x1,) if self.symmetric else (self.x1, self.x2)
        kernel, symmetric, nx, by_dim = self.kernel, self.symmetric, len(xs), self.last_dim_is_batch

        def rebuild(tensors):
            x1, x2 = (tensors[0], tensors[0]) if symmetric else tensors[:2]
            return LazyEvaluatedKernelOperator(kernel, x1, x2, symmetric, dict(zip(names, tensors[nx:])), by_dim)

        return xs + tuple(self.hypers.values()), rebuild

    def _evaluate(self, x1, x2, diag: bool = False):
        kwargs = {"last_dim_is_batch": True} if self.last_dim_is_batch else {}
        return self.kernel.evaluate(self.hypers, x1, x2, diag=diag, **kwargs)

    def _is_big(self) -> bool:
        n, m = self.shape[-2:]
        return n * m > settings.max_eager_kernel_size.value() ** 2 or settings.memory_efficient.on()

    def _structured(self) -> bool:
        return getattr(self.kernel, "returns_lazy_structure", False)

    def evaluate_kernel(self) -> LinearOperator:
        """The kernel's structured operator; else the dense kernel matrix if it is small
        enough (or holds one matrix per input dimension), else this lazy operator."""
        if self._structured() or self.last_dim_is_batch:
            return to_linear_operator(self._evaluate(self.x1, self.x2))
        if self._is_big():
            return self
        return DenseLinearOperator(self._evaluate(self.x1, self.x2))

    def to_dense(self):
        res = self._evaluate(self.x1, self.x2)
        return res.to_dense() if isinstance(res, LinearOperator) else res

    def _diagonal(self):
        if self.x1.shape == self.x2.shape:
            return self._evaluate(self.x1, self.x2, diag=True)
        return self.evaluate_kernel()._diagonal()

    def _get_rows(self, idx):
        """Rows K[..., idx, :] from the rows of x1 they stand for: per batch element
        (``gpytorch_tpu/linop/lazy_kernel.py:268-279``) for idx of shape batch + (m,).

        With t = ``num_outputs_per_input`` > 1 (a derivative kernel's [f, ∂₁f, …] of each
        input) row i of K is output i mod t of input i // t: the kernel is evaluated on
        those inputs, t rows each, and row i mod t of each block is kept.  These are the
        dense matrix's rows, which the JAX package takes from the whole dense matrix
        (``gpytorch_tpu/linop/lazy_kernel.py:268-271``): each entry of a block depends on
        its pair of inputs alone."""
        if self._structured() or self.last_dim_is_batch:
            return self.evaluate_kernel()._get_rows(idx)
        batch, num = self.batch_shape, self._num_outputs()
        idx = idx.expand(batch + idx.shape[-1:])
        x1 = self.x1.expand(batch + self.x1.shape[-2:])
        rows = torch.take_along_dim(x1, torch.div(idx, num, rounding_mode="floor").unsqueeze(-1), dim=-2)
        res = self._evaluate(rows, self.x2)
        res = res.to_dense() if isinstance(res, LinearOperator) else res
        if num == 1:
            return res
        blocks = res.reshape(res.shape[:-2] + (idx.shape[-1], num, res.shape[-1]))
        return torch.take_along_dim(blocks, (idx % num)[..., None, None], dim=-2).squeeze(-2)

    def _dense_products(self) -> bool:
        return self._structured() or self.last_dim_is_batch or not self._is_big()

    def _matmul(self, rhs):
        if self._dense_products():
            return self.evaluate_kernel()._matmul(rhs)
        return self._fused_matmul(rhs)

    def _matmul_grad_only(self, rhs):
        if self._dense_products():
            return self.evaluate_kernel()._matmul(rhs)
        return self._fused_matmul(rhs, grad_only=True)

    def _fused_matmul(self, rhs, grad_only: bool = False):
        """K·rhs through the fused kernel products, for (Scale)(RBF | Matérn | Periodic)
        kernels; other kernels, and a right-hand side of another batch shape than the
        operator's, take ``_matmul_chunked``.

        RBF and Matérn: the centre is detached, as the JAX package stop-gradients it (it only
        conditions the distances, and K does not depend on it), and the outputscale is an
        operand of the scaled product."""
        from ..kernels.scale_kernel import ScaleKernel
        from ..kernels.stationary import PeriodicKernel
        from ..ops import fused_kernels as fk

        kernel, outputscale = self.kernel, self.hypers.get("outputscale")
        prefix = ""
        if isinstance(kernel, ScaleKernel):
            kernel, prefix = kernel.base_kernel, "base_kernel."
        periodic = type(kernel) is PeriodicKernel
        ktype = None if periodic else fk.kernel_type_for(kernel)
        if ktype is None and not periodic:
            return self._matmul_chunked(rhs)
        batch = self.batch_shape
        if tuple(rhs.shape[:-2]) != batch:
            return self._matmul_chunked(rhs)
        # one launch per batch element (one for an unbatched operator), each with its own
        # inputs and hyperparameters
        x1 = _per_element(self.x1, batch, 2)
        x2 = x1 if self.symmetric else _per_element(self.x2, batch, 2)
        v = rhs.reshape((-1,) + rhs.shape[-2:])
        os_ = None if outputscale is None else _per_element(outputscale, batch, 0)
        if periodic:
            per, ls = (_per_element(h, batch, 2) for h in self._periodic_hypers(prefix))
            outs = [self._periodic_matmul(x1[i], x2[i], v[i], (per[i], ls[i]), None if os_ is None else os_[i],
                                          grad_only) for i in range(v.shape[0])]
        else:
            ls = _per_element(self.hypers[prefix + "lengthscale"], batch, 2)
            outs = [self._stationary_matmul(x1[i], x2[i], v[i], ls[i], None if os_ is None else os_[i], ktype,
                                            grad_only) for i in range(v.shape[0])]
        out = torch.stack(outs)
        return out.reshape(batch + out.shape[-2:])

    def _stationary_matmul(self, x1, x2, rhs, ls, outputscale, ktype: int, grad_only: bool):
        """One RBF or Matérn product on 2-D inputs.  The symmetric case scales the inputs
        once and passes that one tensor twice, so that the backward is the one fused pass
        (``kernel_bwd_fused``): scaling them twice would take the general branch."""
        from ..ops import fused_kernels as fk

        center = x1.mean(-2, keepdim=True).detach()
        xs1 = ((x1 - center) / ls).contiguous()
        xs2 = xs1 if self.symmetric else ((x2 - center) / ls).contiguous()
        rhs = rhs.contiguous()
        if outputscale is not None:
            return fk.fused_scaled_kernel_matvec(xs1, xs2, rhs, outputscale, ktype, self.symmetric, grad_only)
        return fk.fused_kernel_matvec(xs1, xs2, rhs, ktype, self.symmetric, grad_only)

    def _periodic_hypers(self, prefix: str):
        return self.hypers[prefix + "period_length"], self.hypers[prefix + "lengthscale"]

    def _periodic_matmul(self, x1, x2, rhs, hypers, outputscale, grad_only: bool):
        """One periodic product on 2-D inputs (``gpytorch_tpu/linop/lazy_kernel.py:200-210``):
        inputs divided by the period, no centring, w = 1/ℓ² per input dim.  The outputscale
        is an operand of the scaled product, whose symmetric backward reads its gradient out
        of the fused kernel, so that training computes no dv (the JAX package folds it into
        the right-hand side and takes its gradient through dv).  The lengthscale's gradient
        flows through w and the period's through x / period, outside the kernels."""
        from ..ops import periodic_kernels as pk

        per, ls = hypers
        w = torch.broadcast_to((1.0 / ls**2).reshape(-1), x1.shape[-1:]).contiguous()
        xs1 = (x1 / per).contiguous()
        xs2 = xs1 if self.symmetric else (x2 / per).contiguous()
        rhs = rhs.contiguous()
        if outputscale is not None:
            return pk.fused_scaled_periodic_matvec(xs1, xs2, w, rhs, outputscale, self.symmetric, grad_only)
        return pk.fused_periodic_matvec(xs1, xs2, w, rhs, self.symmetric, grad_only)

    def _matmul_chunked(self, rhs):
        """K·rhs streamed by blocks of ``_CHUNK`` rows of x1, each block evaluated densely
        (``gpytorch_tpu/linop/lazy_kernel.py:237-260``): for kernels with no fused product,
        and for a right-hand side whose batch shape is not the operator's.  Differentiable
        through each block.

        A kernel with t = ``num_outputs_per_input`` > 1 streams alike: a block of inputs
        gives its t rows each, in the matrix's order.  The JAX package means to multiply
        such a kernel by its dense matrix, but goes through ``evaluate_kernel``, which
        returns the lazy operator itself above ``max_eager_kernel_size``, so that its
        product calls itself until Python's recursion limit (``lazy_kernel.py:239-241``,
        ``:69-70``); here each block is evaluated by the kernel directly and cannot
        recurse."""
        n = self.x1.shape[-2]
        blocks = [to_linear_operator(self._evaluate(self.x1[..., i:i + _CHUNK, :], self.x2))._matmul(rhs)
                  for i in range(0, n, _CHUNK)]
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=-2)

    def __getitem__(self, index):
        """Slice the inputs, not the kernel matrix: ``op[rows, cols]`` or ``op[..., rows,
        cols]`` with two slices.  With ``num_outputs_per_input`` = t > 1, a slice whose
        bounds are multiples of t slices the inputs by bound / t.  Any other index (an
        index tensor, an integer, a batch index) is taken from the dense matrix, as the JAX
        package takes it (``gpytorch_tpu/linop/lazy_kernel.py:281-293``)."""
        if not two_slices(index):
            return super().__getitem__(index)
        row_ix, col_ix = index[-2:]
        num = self._num_outputs()
        if num != 1:
            spans = [ix.indices(size) for ix, size in zip((row_ix, col_ix), self.shape[-2:])]
            if any(step != 1 or start % num or stop % num for start, stop, step in spans):
                return DenseLinearOperator(self.to_dense()[index])
            row_ix, col_ix = (slice(start // num, stop // num) for start, stop, _ in spans)
        symmetric = self.symmetric and row_ix == col_ix
        x1 = _rows(self.x1, row_ix)
        x2 = x1 if symmetric else _rows(self.x2, col_ix)
        return LazyEvaluatedKernelOperator(self.kernel, x1, x2, symmetric, self.hypers, self.last_dim_is_batch)
