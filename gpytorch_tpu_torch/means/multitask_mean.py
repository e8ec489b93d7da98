"""MultitaskMean: one mean module per task.  Counterpart of
``gpytorch_tpu/means/multitask_mean.py``; the means sit in an ``nn.ModuleList`` named
``base_means``, so their parameters are ``base_means.<task>.<name>`` as in the JAX
package's ``trainable_params()``."""

from __future__ import annotations

import copy

import torch

from ..core.module import Module


class MultitaskMean(Module):
    def __init__(self, base_means, num_tasks: int):
        super().__init__()
        if isinstance(base_means, torch.nn.Module):
            base_means = [base_means] + [copy.deepcopy(base_means) for _ in range(num_tasks - 1)]
        if len(base_means) != num_tasks:
            raise RuntimeError("base_means must have length num_tasks")
        self.base_means = torch.nn.ModuleList(base_means)
        self.num_tasks = int(num_tasks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The means of the tasks, of shape (..., n, num_tasks)."""
        return torch.stack([m(x) for m in self.base_means], dim=-1)
