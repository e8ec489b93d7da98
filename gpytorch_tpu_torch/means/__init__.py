from .constant_mean import ConstantMean
from .multitask_mean import MultitaskMean

__all__ = ["ConstantMean", "MultitaskMean"]
