"""Module base on ``torch.nn.Module`` with raw parameters behind constraints.

Counterpart of ``gpytorch_tpu/core/module.py``.  The JAX package builds its own pytree
module system; here ``torch.nn.Module`` already holds parameters and submodules, so this
class only adds what a GP module needs on top: a constraint per raw parameter, constrained
reads, priors on parameters or derived values, added loss terms (objects with a
``loss()`` that a variational objective subtracts), and a per-module cache that
``train()``/``eval()`` clear.

A prior is a submodule (its hyperparameters are buffers), registered with the closure that
reads the value it scores.  ``named_priors`` walks ``nn.Module.named_modules()``, which
visits a module shared by two parents once, so a sum over it counts each prior once.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import torch
from torch import nn


class Module(nn.Module):
    def __init__(self):
        super().__init__()
        self._constraints: Dict[str, object] = {}
        self._priors: Dict[str, Tuple[Union[str, Callable], Optional[Callable]]] = {}
        self._cache: Dict[str, object] = {}
        self._added_loss_terms: Dict[str, object] = {}

    def register_constraint(self, param_name: str, constraint) -> None:
        if param_name not in self._parameters:
            raise RuntimeError(f"Attempting to register constraint for nonexistent parameter {param_name!r}.")
        self._constraints[param_name] = constraint

    def register_prior(self, name: str, prior, param_or_closure: Union[str, Callable],
                       setting_closure: Optional[Callable] = None) -> None:
        """Attach ``prior`` as the submodule ``name``, scoring the parameter (or attribute)
        named ``param_or_closure``, or the value ``param_or_closure(module)``.
        ``setting_closure(module, value)`` writes a value back (``sample_from_prior``)."""
        if isinstance(param_or_closure, str) and not hasattr(self, param_or_closure):
            raise AttributeError(f"Unknown parameter {param_or_closure!r} for prior {name!r}")
        self.add_module(name, prior)
        self._priors[name] = (param_or_closure, setting_closure)

    def named_priors(self) -> Iterator[Tuple[str, "Module", object, Callable, Optional[Callable]]]:
        """(dotted name, module, prior, closure, setting closure) of every prior, each once."""
        for mod_name, module in self.named_modules():
            for prior_name, (param_or_closure, setting_closure) in getattr(module, "_priors", {}).items():
                if isinstance(param_or_closure, str):
                    closure = lambda m, _name=param_or_closure: getattr(m, _name)  # noqa: E731
                else:
                    closure = param_or_closure
                full = f"{mod_name}.{prior_name}" if mod_name else prior_name
                yield full, module, getattr(module, prior_name), closure, setting_closure

    def prior_log_prob_sum(self) -> Optional[torch.Tensor]:
        """Σ over the priors of the summed log-density of the value each scores; None
        without priors."""
        total = None
        for _, module, prior, closure, _ in self.named_priors():
            lp = prior.log_prob(closure(module)).sum()
            total = lp if total is None else total + lp
        return total

    def sample_from_prior(self, prior_name: str, generator: Optional[torch.Generator] = None) -> "Module":
        """Draw from this module's prior ``prior_name`` and write the draw back, through
        the prior's setting closure or into the parameter it names."""
        if prior_name not in self._priors:
            raise RuntimeError(f"Unknown prior {prior_name!r}")
        param_or_closure, setting_closure = self._priors[prior_name]
        if setting_closure is None and not isinstance(param_or_closure, str):
            raise RuntimeError(f"Prior {prior_name!r} has no setting closure")
        value = getattr(self, prior_name).sample(generator=generator)
        if setting_closure is not None:
            setting_closure(self, value)
        else:
            self._set_constrained(param_or_closure, value)
        return self

    def register_added_loss_term(self, name: str) -> None:
        self._added_loss_terms[name] = None

    def update_added_loss_term(self, name: str, added_loss_term) -> None:
        if name not in self._added_loss_terms:
            raise RuntimeError(f"added_loss_term {name!r} not registered")
        self._added_loss_terms[name] = added_loss_term

    def added_loss_terms(self) -> Iterator[object]:
        """The added loss terms set on this module and its submodules."""
        for module in self.modules():
            for term in getattr(module, "_added_loss_terms", {}).values():
                if term is not None:
                    yield term

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
