from .kernel import AdditiveKernel, Kernel, ProductKernel
from .scale_kernel import ConstantKernel, ScaleKernel
from .stationary import CosineKernel, MaternKernel, PeriodicKernel, RBFKernel, RQKernel
from .grad_kernels import Matern52KernelGrad, PolynomialKernelGrad, RBFKernelGrad, RBFKernelGradGrad
from .grid_kernel import GridKernel
from .grid_interpolation_kernel import GridInterpolationKernel
from .index_kernel import IndexKernel
from .inducing_point_kernel import InducingPointKernel
from .linear_kernel import LinearKernel, PolynomialKernel
from .misc_kernels import (ArcKernel, CylindricalKernel, DistributionalInputKernel, GaussianSymmetrizedKLKernel,
                           GibbsKernel, HammingIMQKernel, SphericalLinearKernel, hamming_dist,
                           project_onto_unit_sphere)
from .multitask_kernel import LCMKernel, MultitaskKernel
from .piecewise_polynomial_kernel import PiecewisePolynomialKernel
from .rff_kernel import RFFKernel
from .spectral_delta_kernel import SpectralDeltaKernel
from .spectral_mixture_kernel import SpectralMixtureKernel
from .structure_kernels import AdditiveStructureKernel, NewtonGirardAdditiveKernel, ProductStructureKernel

__all__ = ["AdditiveKernel", "AdditiveStructureKernel", "ArcKernel", "ConstantKernel", "CosineKernel",
           "CylindricalKernel", "DistributionalInputKernel", "GaussianSymmetrizedKLKernel", "GibbsKernel",
           "GridInterpolationKernel", "GridKernel", "HammingIMQKernel", "IndexKernel", "InducingPointKernel", "Kernel",
           "LCMKernel", "LinearKernel", "Matern52KernelGrad", "MaternKernel", "MultitaskKernel",
           "NewtonGirardAdditiveKernel", "PeriodicKernel", "PiecewisePolynomialKernel", "PolynomialKernel",
           "PolynomialKernelGrad", "ProductKernel", "ProductStructureKernel", "RBFKernel", "RBFKernelGrad",
           "RBFKernelGradGrad", "RFFKernel", "RQKernel", "ScaleKernel", "SpectralDeltaKernel", "SpectralMixtureKernel",
           "SphericalLinearKernel", "hamming_dist", "project_onto_unit_sphere"]
