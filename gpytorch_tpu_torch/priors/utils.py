"""Prior (de)serialisation helpers.  Counterpart of ``gpytorch_tpu/priors/utils.py``, kept for
the API: a prior's hyperparameters are buffers here already, so these are attribute moves."""

from __future__ import annotations

BUFFERED_PREFIX = "_buffered_"


def _bufferize_attributes(module, attributes) -> None:
    """Make each named attribute of ``module`` a buffer of the same value."""
    for attr in attributes:
        value = getattr(module, attr)
        if attr not in module._buffers:
            delattr(module, attr)
            module.register_buffer(attr, value)


def _load_transformed_to_base_dist(module):
    """Copy each ``_buffered_<name>`` attribute of ``module`` to ``<name>``."""
    for attr in dir(module):
        if attr.startswith(BUFFERED_PREFIX):
            setattr(module, attr[len(BUFFERED_PREFIX):], getattr(module, attr))
    return module


def _del_attributes(module, attributes, raise_on_error: bool = False):
    for attr in attributes:
        try:
            delattr(module, attr)
        except AttributeError:
            if raise_on_error:
                raise
    return module


__all__ = ["_bufferize_attributes", "_load_transformed_to_base_dist", "_del_attributes"]
