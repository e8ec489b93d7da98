"""IndexKernel — the task covariance B Bᵀ + diag(v) of a multitask model.

Counterpart of ``gpytorch_tpu/kernels/index_kernel.py``.  ``covar_factor`` B (num_tasks ×
rank) has no constraint; it starts as a standard-normal draw from a ``torch.Generator``
seeded with 0 (the JAX package draws it from ``PRNGKey(0)``: to start both packages
alike, load the JAX values with ``load_jax_params``).  ``raw_var`` holds v under a
``Positive`` constraint.  Its inputs are task indices, as a column of floats or integers.
"""

from __future__ import annotations

import torch

from ..constraints import Positive
from .kernel import Kernel


class IndexKernel(Kernel):
    def __init__(self, num_tasks: int, rank: int = 1, prior=None, var_constraint=None, **kwargs):
        if rank > num_tasks:
            raise RuntimeError("Cannot create a task covariance matrix larger than the number of tasks")
        super().__init__(**kwargs)
        self.num_tasks, self.rank = int(num_tasks), int(rank)
        generator = torch.Generator().manual_seed(0)
        factor = torch.randn(self.batch_shape + (self.num_tasks, self.rank), generator=generator)
        self.register_parameter("covar_factor", torch.nn.Parameter(factor))
        self.register_parameter("raw_var", torch.nn.Parameter(torch.zeros(self.batch_shape + (self.num_tasks,))))
        self.register_constraint("raw_var", var_constraint or Positive())
        if prior is not None:
            self.register_prior("IndexKernelPrior", prior, lambda m: m.covar_matrix)

    @property
    def var(self) -> torch.Tensor:
        return self._constrained("raw_var")

    @var.setter
    def var(self, value) -> None:
        self._set_constrained("raw_var", value)

    def hypers(self):
        return {"covar_factor": self.covar_factor, "var": self.var}

    @staticmethod
    def task_covar(hypers) -> torch.Tensor:
        """B Bᵀ + diag(v), of shape batch + (num_tasks, num_tasks)."""
        cf, var = hypers["covar_factor"], hypers["var"]
        return cf @ cf.mT + torch.diag_embed(var)

    @property
    def covar_matrix(self) -> torch.Tensor:
        return self.task_covar(self.hypers())

    def evaluate(self, hypers, x1, x2, diag: bool = False):
        """B[i1, i2] (or its diagonal) as E₁ B E₂ᵀ with one-hot rows E of the task indices:
        products instead of a gather, whose backward would scatter n·m cotangents into the
        t × t entries of B (atomic adds that serialise on a GPU)."""
        covar = self.task_covar(hypers)
        e1, e2 = (torch.nn.functional.one_hot((x.squeeze(-1) if x.shape[-1] == 1 else x).long(), self.num_tasks)
                  .to(covar.dtype) for x in (x1, x2))
        if diag:
            return ((e1 @ covar) * e2).sum(-1)
        return e1 @ covar @ e2.mT
