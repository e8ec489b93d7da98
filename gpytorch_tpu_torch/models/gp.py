"""GP — the base class of every Gaussian-process model.  Counterpart of
``gpytorch_tpu/models/gp.py``."""

from __future__ import annotations

from ..core.module import Module


class GP(Module):
    pass
