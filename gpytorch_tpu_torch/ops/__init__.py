from . import fused_kernels, periodic_kernels
from .sq_dist import sq_dist

__all__ = ["fused_kernels", "periodic_kernels", "sq_dist"]
