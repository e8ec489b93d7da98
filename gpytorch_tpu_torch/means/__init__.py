from .mean import Mean
from .constant_mean import ConstantMean
from .grad_means import ConstantMeanGrad, ConstantMeanGradGrad, LinearMeanGrad, LinearMeanGradGrad
from .linear_mean import LinearMean
from .multitask_mean import MultitaskMean
from .zero_mean import ZeroMean

__all__ = ["ConstantMean", "ConstantMeanGrad", "ConstantMeanGradGrad", "LinearMean", "LinearMeanGrad",
           "LinearMeanGradGrad", "Mean", "MultitaskMean", "ZeroMean"]
