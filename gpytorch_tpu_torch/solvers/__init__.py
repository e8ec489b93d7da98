from .cg import CGResult, linear_cg, linear_solve_cg, tridiag_from_coeffs
from .cholesky import psd_safe_cholesky
from .inv_quad import MBCGState, inv_quad_logdet_mbcg
from .contour import contour_integral_quad, shifted_cg, sqrt_inv_matmul
from .lanczos import block_lanczos_ritz, lanczos_inv_root, lanczos_root, lanczos_tridiag
from .pivoted_cholesky import nystrom_factor_from_pivots, pivoted_cholesky

__all__ = [
    "CGResult",
    "MBCGState",
    "block_lanczos_ritz",
    "contour_integral_quad",
    "inv_quad_logdet_mbcg",
    "lanczos_inv_root",
    "lanczos_root",
    "lanczos_tridiag",
    "linear_cg",
    "linear_solve_cg",
    "nystrom_factor_from_pivots",
    "pivoted_cholesky",
    "psd_safe_cholesky",
    "shifted_cg",
    "sqrt_inv_matmul",
    "tridiag_from_coeffs",
]
