from .kernel import Kernel
from .scale_kernel import ScaleKernel
from .stationary import PeriodicKernel, RBFKernel

__all__ = ["Kernel", "PeriodicKernel", "RBFKernel", "ScaleKernel"]
