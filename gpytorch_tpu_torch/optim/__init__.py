from .warm_start import rhs_warm_context

__all__ = ["rhs_warm_context"]
