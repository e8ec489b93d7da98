from .kernel import Kernel
from .scale_kernel import ScaleKernel
from .stationary import MaternKernel, PeriodicKernel, RBFKernel
from .grid_kernel import GridKernel
from .grid_interpolation_kernel import GridInterpolationKernel
from .index_kernel import IndexKernel
from .multitask_kernel import LCMKernel, MultitaskKernel

__all__ = ["GridInterpolationKernel", "GridKernel", "IndexKernel", "Kernel", "LCMKernel", "MaternKernel",
           "MultitaskKernel", "PeriodicKernel", "RBFKernel", "ScaleKernel"]
