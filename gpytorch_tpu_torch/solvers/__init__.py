from .cg import CGResult, linear_cg, linear_solve_cg, tridiag_from_coeffs
from .cholesky import psd_safe_cholesky
from .inv_quad import MBCGState, inv_quad_logdet_mbcg
from .lanczos import block_lanczos_ritz, lanczos_inv_root, lanczos_root
from .pivoted_cholesky import nystrom_factor_from_pivots, pivoted_cholesky

__all__ = [
    "CGResult",
    "MBCGState",
    "block_lanczos_ritz",
    "inv_quad_logdet_mbcg",
    "lanczos_inv_root",
    "lanczos_root",
    "linear_cg",
    "linear_solve_cg",
    "nystrom_factor_from_pivots",
    "pivoted_cholesky",
    "psd_safe_cholesky",
    "tridiag_from_coeffs",
]
