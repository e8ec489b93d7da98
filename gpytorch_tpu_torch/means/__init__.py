from .constant_mean import ConstantMean
from .linear_mean import LinearMean
from .multitask_mean import MultitaskMean

__all__ = ["ConstantMean", "LinearMean", "MultitaskMean"]
