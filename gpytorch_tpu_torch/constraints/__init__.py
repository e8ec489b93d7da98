from .constraints import GreaterThan, Interval, LessThan, Positive

__all__ = ["GreaterThan", "Interval", "LessThan", "Positive"]
