"""Prior base class.  Counterpart of ``gpytorch_tpu/priors/prior.py``.

A prior is a ``Module`` whose hyperparameters are buffers, not parameters: they move with
``.to()`` and are saved in ``state_dict``, but an optimizer over ``model.parameters()``
never sees them, and ``load_jax_params`` matches the same parameter names as the JAX
package's ``trainable_params()``.  ``log_prob`` builds its ``torch.distributions`` object
from the buffers at each call, so that it lies on the buffers' current device and dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.module import Module


class Prior(Module):
    """Subclasses define ``distribution()`` (a ``torch.distributions`` object built from
    their buffers) and ``sample``."""

    def distribution(self) -> torch.distributions.Distribution:
        raise NotImplementedError

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.distribution().log_prob(x)

    def sample(self, sample_shape: Sequence[int] = (), generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Draws of shape ``sample_shape`` + the prior's batch shape, from ``generator``
        (torch's default generator when None)."""
        raise NotImplementedError

    def forward(self, *args, **kwargs):
        raise RuntimeError("Priors are not callable modules")
