from .constraints import GreaterThan, Interval, Positive

__all__ = ["GreaterThan", "Interval", "Positive"]
