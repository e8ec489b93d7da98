"""Multitask kernels on interleaved outputs (task index fastest).

Counterpart of ``gpytorch_tpu/kernels/multitask_kernel.py``: ``MultitaskKernel`` gives
K_data ⊗ K_task, a ``KroneckerProductLinearOperator`` of the data kernel's dense matrix
and an ``IndexKernel``'s B Bᵀ + diag(v); ``LCMKernel`` the sum of several of them (the
linear model of coregionalisation).  Both return a structured operator
(``returns_lazy_structure``): the lazy kernel operator evaluates them whatever their size,
and a solver sees the Kronecker structure, with K_data formed once per evaluation.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..linop import DenseLinearOperator, KroneckerProductLinearOperator, SumLinearOperator, to_linear_operator
from .index_kernel import IndexKernel
from .kernel import Kernel, sub_hypers


class MultitaskKernel(Kernel):
    returns_lazy_structure = True

    def __init__(self, data_covar_module: Kernel, num_tasks: int, rank: int = 1, task_covar_prior=None, **kwargs):
        super().__init__(**kwargs)
        self.task_covar_module = IndexKernel(num_tasks=num_tasks, rank=rank, prior=task_covar_prior,
                                             batch_shape=self.batch_shape)
        self.data_covar_module = data_covar_module
        self.num_tasks = int(num_tasks)

    def num_outputs_per_input(self, x1, x2) -> int:
        return self.num_tasks

    def hypers(self):
        return {**{f"data_covar_module.{k}": v for k, v in self.data_covar_module.hypers().items()},
                **{f"task_covar_module.{k}": v for k, v in self.task_covar_module.hypers().items()}}

    def evaluate(self, hypers, x1, x2, diag: bool = False):
        covar_i = IndexKernel.task_covar(sub_hypers(hypers, "task_covar_module."))
        covar_x = self.data_covar_module.evaluate(sub_hypers(hypers, "data_covar_module."), x1, x2, diag=diag)
        covar_x = covar_x.to_dense() if not torch.is_tensor(covar_x) else covar_x
        if diag:  # diag(K_data ⊗ K_task), task index fastest
            task = torch.diagonal(covar_i, dim1=-2, dim2=-1)
            return (covar_x.unsqueeze(-1) * task.unsqueeze(-2)).flatten(-2)
        return KroneckerProductLinearOperator(DenseLinearOperator(covar_x), DenseLinearOperator(covar_i))


class LCMKernel(Kernel):
    """Σ_q K_q ⊗ B_q: one ``MultitaskKernel`` per base kernel, each with its own task
    covariance of rank ``rank`` (or ``rank[q]``)."""

    returns_lazy_structure = True

    def __init__(self, base_kernels: Sequence[Kernel], num_tasks: int, rank=1, task_covar_prior=None, **kwargs):
        if not isinstance(base_kernels, (list, tuple)) or len(base_kernels) < 1:
            raise RuntimeError("base_kernels must be a nonempty list")
        super().__init__(**kwargs)
        ranks = list(rank) if isinstance(rank, (list, tuple)) else [rank] * len(base_kernels)
        self.covar_module_list = torch.nn.ModuleList(
            MultitaskKernel(k, num_tasks=num_tasks, rank=r, task_covar_prior=task_covar_prior)
            for k, r in zip(base_kernels, ranks))
        self.num_tasks = int(num_tasks)

    def num_outputs_per_input(self, x1, x2) -> int:
        return self.num_tasks

    def hypers(self):
        return {f"covar_module_list.{q}.{k}": v for q, m in enumerate(self.covar_module_list)
                for k, v in m.hypers().items()}

    def evaluate(self, hypers, x1, x2, diag: bool = False):
        parts = [m.evaluate(sub_hypers(hypers, f"covar_module_list.{q}."), x1, x2, diag=diag)
                 for q, m in enumerate(self.covar_module_list)]
        if diag:
            return sum(parts[1:], parts[0])
        return SumLinearOperator(*[to_linear_operator(p) for p in parts])
