"""Kernel base class.

Counterpart of ``gpytorch_tpu/kernels/kernel.py``.  ``__call__`` returns a
``LazyEvaluatedKernelOperator``, so K is never formed until a solver asks for it; the
operator records explicitly whether it is symmetric (``__call__`` was given one input).

A kernel is evaluated from explicit hyperparameter tensors (``evaluate(hypers, ...)``),
which ``hypers()`` reads from the module's constrained parameters.  The lazy operator
holds those tensors, so a solver's backward can rebuild it from copies of them and
differentiate (the counterpart of the JAX package's pytree ``tree_map``).

``batch_shape`` gives every hyperparameter leading batch dimensions (a lengthscale of shape
batch + (1, d)): a batch of independent kernels, evaluated on batched or shared inputs.
``active_dims`` restricts the kernel to some input columns, chosen in ``__call__``.
``last_dim_is_batch`` evaluates the kernel on each input dimension alone, the dimensions a
batch dimension after the others: (…, d, n, m) (the RBF, Matérn, periodic, scale and grid
kernels take it, in ``evaluate``).  ``AdditiveKernel`` and ``ProductKernel`` (``k1 + k2``,
``k1 * k2``) sum and multiply their kernels' matrices.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..constraints import Positive
from ..core.module import Module
from ..linop import LazyEvaluatedKernelOperator, LinearOperator
from ..ops.sq_dist import sq_dist


class Kernel(Module):
    has_lengthscale = False

    def __init__(self, ard_num_dims: Optional[int] = None, batch_shape: Sequence[int] = (),
                 active_dims: Optional[Sequence[int]] = None, lengthscale_prior=None, lengthscale_constraint=None):
        super().__init__()
        self.ard_num_dims = ard_num_dims
        self.batch_shape = tuple(int(b) for b in batch_shape)
        self.active_dims = None if active_dims is None else tuple(int(i) for i in active_dims)
        if self.has_lengthscale:
            num_dims = 1 if ard_num_dims is None else ard_num_dims
            self.register_parameter("raw_lengthscale", torch.nn.Parameter(torch.zeros(self.batch_shape + (1, num_dims))))
            self.register_constraint("raw_lengthscale", lengthscale_constraint or Positive())
            if lengthscale_prior is not None:
                self.register_prior("lengthscale_prior", lengthscale_prior, lambda m: m.lengthscale,
                                    lambda m, v: m._set_constrained("raw_lengthscale", v))

    @property
    def lengthscale(self) -> Optional[torch.Tensor]:
        if not self.has_lengthscale:
            return None
        return self._constrained("raw_lengthscale")

    @lengthscale.setter
    def lengthscale(self, value) -> None:
        self._set_constrained("raw_lengthscale", value)

    def num_outputs_per_input(self, x1, x2) -> int:
        """Rows of the kernel matrix per input row: 1, or the number of tasks of a
        multitask kernel."""
        return 1

    def hypers(self) -> Dict[str, torch.Tensor]:
        """The constrained hyperparameters ``evaluate`` reads, by (dotted) name."""
        return {"lengthscale": self.lengthscale} if self.has_lengthscale else {}

    def covar_dist(self, x1, x2, diag: bool = False):
        """Pairwise squared distances, or the elementwise ones with ``diag``."""
        if diag:
            return ((x1 - x2) ** 2).sum(-1)
        return sq_dist(x1, x2)

    def evaluate(self, hypers: Dict[str, torch.Tensor], x1, x2, diag: bool = False, **kwargs):
        """The kernel matrix (or its diagonal) from the hyperparameter tensors ``hypers``;
        a kernel that takes ``last_dim_is_batch=True`` returns (…, d, n, m)."""
        raise NotImplementedError

    def forward(self, x1, x2, diag: bool = False, last_dim_is_batch: bool = False):
        return self.evaluate(self.hypers(), x1, x2, diag=diag, **_flag(last_dim_is_batch))

    def _select(self, x1, x2=None):
        """x1 (and x2) as (…, n, d), restricted to ``active_dims``."""
        x1 = x1.unsqueeze(-1) if x1.ndim == 1 else x1
        if x2 is not None:
            x2 = x2.unsqueeze(-1) if x2.ndim == 1 else x2
        if self.active_dims is not None:
            x1 = x1[..., list(self.active_dims)]
            x2 = None if x2 is None else x2[..., list(self.active_dims)]
        return x1, x2

    def __add__(self, other: "Kernel") -> "AdditiveKernel":
        return AdditiveKernel(*(self.kernels if isinstance(self, AdditiveKernel) else [self]),
                              *(other.kernels if isinstance(other, AdditiveKernel) else [other]))

    def __mul__(self, other: "Kernel") -> "ProductKernel":
        return ProductKernel(*(self.kernels if isinstance(self, ProductKernel) else [self]),
                             *(other.kernels if isinstance(other, ProductKernel) else [other]))

    def __call__(self, x1, x2=None, diag: bool = False, last_dim_is_batch: bool = False):
        symmetric = x2 is None
        x1, x2 = self._select(x1, x2)
        if symmetric:
            x2 = x1
        if diag:
            return self.forward(x1, x2, diag=True, last_dim_is_batch=last_dim_is_batch)
        return LazyEvaluatedKernelOperator(self, x1, x2, symmetric=symmetric, last_dim_is_batch=last_dim_is_batch)

    def prediction_strategy(self, train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init=None):
        from ..models.exact_prediction_strategies import DefaultPredictionStrategy

        return DefaultPredictionStrategy(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init)


def _flag(last_dim_is_batch: bool) -> dict:
    """The keyword ``last_dim_is_batch=True`` where it is set: a kernel that does not take
    it is called without it."""
    return {"last_dim_is_batch": True} if last_dim_is_batch else {}


def sub_hypers(hypers: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The hyperparameters under ``prefix`` (a submodule's), the prefix taken off."""
    return {k[len(prefix):]: v for k, v in hypers.items() if k.startswith(prefix)}


def _dense(res):
    return res.to_dense() if isinstance(res, LinearOperator) else res


class _CompositeKernel(Kernel):
    def __init__(self, *kernels: Kernel):
        super().__init__()
        self.kernels = torch.nn.ModuleList(kernels)

    def hypers(self):
        return {f"kernels.{i}.{k}": v for i, kern in enumerate(self.kernels) for k, v in kern.hypers().items()}

    def num_outputs_per_input(self, x1, x2) -> int:
        return self.kernels[0].num_outputs_per_input(x1, x2)

    def _parts(self, hypers, x1, x2, diag, kwargs):
        """Each kernel's matrix (its diagonal), dense, on its own ``active_dims``."""
        for i, kern in enumerate(self.kernels):
            a, b = kern._select(x1, x2)
            yield _dense(kern.evaluate(sub_hypers(hypers, f"kernels.{i}."), a, b, diag=diag, **kwargs))


class AdditiveKernel(_CompositeKernel):
    """The sum of its kernels' matrices (``gpytorch_tpu/kernels/kernel.py::AdditiveKernel``)."""

    def evaluate(self, hypers, x1, x2, diag: bool = False, **kwargs):
        return sum(self._parts(hypers, x1, x2, diag, kwargs))


class ProductKernel(_CompositeKernel):
    """The elementwise product of its kernels' matrices
    (``gpytorch_tpu/kernels/kernel.py::ProductKernel``)."""

    def evaluate(self, hypers, x1, x2, diag: bool = False, **kwargs):
        parts = self._parts(hypers, x1, x2, diag, kwargs)
        out = next(parts)
        for part in parts:
            out = out * part
        return out
