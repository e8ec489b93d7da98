from .kernel import Kernel
from .scale_kernel import ScaleKernel
from .stationary import MaternKernel, PeriodicKernel, RBFKernel

__all__ = ["Kernel", "MaternKernel", "PeriodicKernel", "RBFKernel", "ScaleKernel"]
