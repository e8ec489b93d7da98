from .kernel import Kernel
from .scale_kernel import ScaleKernel
from .stationary import MaternKernel, PeriodicKernel, RBFKernel
from .grid_kernel import GridKernel
from .grid_interpolation_kernel import GridInterpolationKernel

__all__ = ["GridInterpolationKernel", "GridKernel", "Kernel", "MaternKernel", "PeriodicKernel", "RBFKernel",
           "ScaleKernel"]
