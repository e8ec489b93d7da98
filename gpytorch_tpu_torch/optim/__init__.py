from .ngd import NGD
from .warm_start import rhs_warm_context

__all__ = ["NGD", "rhs_warm_context"]
