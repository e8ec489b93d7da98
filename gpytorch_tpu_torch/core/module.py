"""Module base on ``torch.nn.Module`` with raw parameters behind constraints.

Counterpart of ``gpytorch_tpu/core/module.py``.  The JAX package builds its own pytree
module system; here ``torch.nn.Module`` already holds parameters and submodules, so this
class only adds what a GP module needs on top: a constraint per raw parameter, constrained
reads, and a per-module cache that ``train()``/``eval()`` clear.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


class Module(nn.Module):
    def __init__(self):
        super().__init__()
        self._constraints: Dict[str, object] = {}
        self._cache: Dict[str, object] = {}

    def register_constraint(self, param_name: str, constraint) -> None:
        if param_name not in self._parameters:
            raise RuntimeError(f"Attempting to register constraint for nonexistent parameter {param_name!r}.")
        self._constraints[param_name] = constraint

    def _constrained(self, raw_name: str) -> torch.Tensor:
        raw = getattr(self, raw_name)
        constraint = self._constraints.get(raw_name)
        return constraint.transform(raw) if constraint is not None else raw

    def _set_constrained(self, raw_name: str, value) -> None:
        """Set the raw parameter so that its constrained value is ``value`` (broadcast to
        the parameter's shape).  Raises ``ValueError`` for a value outside the constraint."""
        raw = getattr(self, raw_name)
        constraint = self._constraints.get(raw_name)
        value = torch.as_tensor(value, dtype=raw.dtype, device=raw.device)
        if constraint is not None:
            if not constraint.check(value):
                raise ValueError(f"Value for parameter {raw_name!r} must lie within {constraint!r}")
            value = constraint.inverse_transform(value)
        with torch.no_grad():
            raw.copy_(value.expand_as(raw))
        self.clear_caches()

    def initialize(self, **kwargs) -> "Module":
        """Set constrained values by name (``noise=0.1``, or dotted paths such as
        ``covar_module.base_kernel.lengthscale=0.5``)."""
        for name, value in kwargs.items():
            if "." in name:
                head, rest = name.split(".", 1)
                getattr(self, head).initialize(**{rest: value})
            elif f"raw_{name}" in self._parameters:
                self._set_constrained(f"raw_{name}", value)
            else:
                raise AttributeError(f"Unknown parameter {name!r} for {type(self).__name__}")
        return self

    def train(self, mode: bool = True) -> "Module":
        super().train(mode)
        self.clear_caches()
        return self

    def clear_caches(self) -> None:
        self._cache.clear()
