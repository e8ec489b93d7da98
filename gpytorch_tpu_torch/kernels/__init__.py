from .kernel import AdditiveKernel, Kernel, ProductKernel
from .scale_kernel import ScaleKernel
from .stationary import MaternKernel, PeriodicKernel, RBFKernel
from .grid_kernel import GridKernel
from .grid_interpolation_kernel import GridInterpolationKernel
from .index_kernel import IndexKernel
from .inducing_point_kernel import InducingPointKernel
from .multitask_kernel import LCMKernel, MultitaskKernel
from .rff_kernel import RFFKernel
from .structure_kernels import AdditiveStructureKernel, NewtonGirardAdditiveKernel, ProductStructureKernel

__all__ = ["AdditiveKernel", "AdditiveStructureKernel", "GridInterpolationKernel", "GridKernel", "IndexKernel",
           "InducingPointKernel", "Kernel", "LCMKernel", "MaternKernel", "MultitaskKernel", "NewtonGirardAdditiveKernel",
           "PeriodicKernel", "ProductKernel", "ProductStructureKernel", "RBFKernel", "RFFKernel", "ScaleKernel"]
