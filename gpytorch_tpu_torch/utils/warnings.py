"""Warning classes.  Counterpart of ``gpytorch_tpu/utils/warnings.py``, as far as exact GPs
need them."""


class GPInputWarning(UserWarning):
    """Input mismatch warnings (e.g. an eval-mode call on the training inputs)."""
