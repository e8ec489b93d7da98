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
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import settings
from .base import DenseLinearOperator, LinearOperator, to_linear_operator


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
    """x[ix] for a slice of rows: the part itself where x was joined by ``join_rows`` and
    ix is exactly one part's rows."""
    span = ix.indices(x.shape[-2])
    for start, stop, part in getattr(x, "_joined_parts", ()):
        if span == (start, stop, 1):
            return part
    return x[ix]


class LazyEvaluatedKernelOperator(LinearOperator):
    def __init__(self, kernel, x1: torch.Tensor, x2: torch.Tensor, symmetric: bool = False,
                 hypers: Optional[Dict[str, torch.Tensor]] = None):
        self.kernel = kernel
        self.x1 = x1
        self.x2 = x2
        self.symmetric = bool(symmetric)
        # the kernel's hyperparameters as tensors, read once: every evaluation and product
        # goes through them, so an operator rebuilt from copies differentiates (_flatten)
        self.hypers = kernel.hypers() if hypers is None else dict(hypers)

    def _is_known_psd(self) -> bool:
        # K(X, X) of a valid kernel is PSD; a cross-covariance K(X, Z) is not
        return self.symmetric

    def _shape(self):
        return (self.x1.shape[-2], self.x2.shape[-2])

    @property
    def dtype(self):
        return self.x1.dtype

    @property
    def device(self):
        return self.x1.device

    def _flatten(self):
        names = list(self.hypers)
        xs = (self.x1,) if self.symmetric else (self.x1, self.x2)
        kernel, symmetric, nx = self.kernel, self.symmetric, len(xs)

        def rebuild(tensors):
            x1, x2 = (tensors[0], tensors[0]) if symmetric else tensors[:2]
            return LazyEvaluatedKernelOperator(kernel, x1, x2, symmetric, dict(zip(names, tensors[nx:])))

        return xs + tuple(self.hypers.values()), rebuild

    def _evaluate(self, x1, x2, diag: bool = False):
        return self.kernel.evaluate(self.hypers, x1, x2, diag=diag)

    def _is_big(self) -> bool:
        n, m = self.shape
        return n * m > settings.max_eager_kernel_size.value() ** 2 or settings.memory_efficient.on()

    def _structured(self) -> bool:
        return getattr(self.kernel, "returns_lazy_structure", False)

    def evaluate_kernel(self) -> LinearOperator:
        """The kernel's structured operator; else the dense kernel matrix if it is small
        enough, else this lazy operator."""
        if self._structured():
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
        if self._structured():
            return self.evaluate_kernel()._get_rows(idx)
        return self._evaluate(self.x1[idx], self.x2)

    def _matmul(self, rhs):
        if self._structured() or not self._is_big():
            return self.evaluate_kernel()._matmul(rhs)
        return self._fused_matmul(rhs)

    def _matmul_grad_only(self, rhs):
        if self._structured() or not self._is_big():
            return self.evaluate_kernel()._matmul(rhs)
        return self._fused_matmul(rhs, grad_only=True)

    def _fused_matmul(self, rhs, grad_only: bool = False):
        """K·rhs through the fused kernel products, for (Scale)(RBF | Matérn | Periodic)
        kernels.

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
        if type(kernel) is PeriodicKernel:
            return self._periodic_matmul(rhs, prefix, outputscale, grad_only)
        ktype = fk.kernel_type_for(kernel)
        if ktype is None:
            raise NotImplementedError(f"no fused matvec for {type(kernel).__name__}")
        ls = self.hypers[prefix + "lengthscale"]
        center = self.x1.mean(-2, keepdim=True).detach()
        xs1 = ((self.x1 - center) / ls).contiguous()
        # symmetric: scale once and pass the same tensor twice
        xs2 = xs1 if self.symmetric else ((self.x2 - center) / ls).contiguous()
        rhs = rhs.contiguous()
        if outputscale is not None:
            return fk.fused_scaled_kernel_matvec(xs1, xs2, rhs, outputscale, ktype, self.symmetric, grad_only)
        return fk.fused_kernel_matvec(xs1, xs2, rhs, ktype, self.symmetric, grad_only)

    def _periodic_matmul(self, rhs, prefix: str, outputscale, grad_only: bool):
        """The periodic branch (``gpytorch_tpu/linop/lazy_kernel.py:200-210``): inputs
        divided by the period, no centring, w = 1/ℓ² per input dim.  The outputscale is an
        operand of the scaled product, whose symmetric backward reads its gradient out of
        the fused kernel, so that training computes no dv (the JAX package folds it into
        the right-hand side and takes its gradient through dv).  The lengthscale's gradient
        flows through w and the period's through x / period, outside the kernels."""
        from ..ops import periodic_kernels as pk

        per = self.hypers[prefix + "period_length"]
        ls = self.hypers[prefix + "lengthscale"]
        w = torch.broadcast_to((1.0 / ls**2).reshape(-1), self.x1.shape[-1:]).contiguous()
        xs1 = (self.x1 / per).contiguous()
        xs2 = xs1 if self.symmetric else (self.x2 / per).contiguous()
        rhs = rhs.contiguous()
        if outputscale is not None:
            return pk.fused_scaled_periodic_matvec(xs1, xs2, w, rhs, outputscale, self.symmetric, grad_only)
        return pk.fused_periodic_matvec(xs1, xs2, w, rhs, self.symmetric, grad_only)

    def __getitem__(self, index):
        """Slice the inputs, not the kernel matrix: ``op[rows, cols]`` with two slices."""
        row_ix, col_ix = index
        if not (isinstance(row_ix, slice) and isinstance(col_ix, slice)):
            raise NotImplementedError("only (slice, slice) indexing is ported")
        symmetric = self.symmetric and row_ix == col_ix
        x1 = _rows(self.x1, row_ix)
        x2 = x1 if symmetric else _rows(self.x2, col_ix)
        return LazyEvaluatedKernelOperator(self.kernel, x1, x2, symmetric, self.hypers)
