from . import fused_kernels, interp, periodic_kernels, toeplitz
from .sq_dist import sq_dist

__all__ = ["fused_kernels", "interp", "periodic_kernels", "sq_dist", "toeplitz"]
