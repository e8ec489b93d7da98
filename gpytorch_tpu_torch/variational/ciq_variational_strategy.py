"""The CIQ variational strategy: the whitened strategy with K_ZZ^{-1/2} by contour-integral
quadrature in place of a Cholesky factor.  Counterpart of
``gpytorch_tpu/variational/ciq_variational_strategy.py`` (Pleiss et al. 2020, arXiv
2006.11267).

q(u) lives on the whitened inducing values, whose prior is N(0, I), and with
A = K_ZZ^{-1/2} K_Zx (``solvers/contour.py``, no preconditioner)

    μ_f = μ_x + Aᵀ m,    Σ_f = K_xx + Aᵀ S A − Aᵀ A.

K_ZZ is the slice of the kernel operator on the joint inputs [Z; x] (``join_rows``), which
keeps it symmetric on Z itself: above ``max_eager_kernel_size``² it stays lazy, so that
each multi-shift CG iteration is one launch of the K·V kernel and the backward's operator
cotangents one launch of the fused symmetric backward kernel (and no grad_x).  K_Zx is
evaluated densely, and K_xx stays lazy (a variational objective reads its diagonal).  As in
the JAX package, a natural-parameter q(u) takes the same whitened formulas (there is no
separate natural-gradient path).
"""

from __future__ import annotations

from .. import settings
from ..distributions import MultivariateNormal
from ..linop import RootLinearOperator, SumLinearOperator
from ..solvers.contour import sqrt_inv_matmul
from ._variational_strategy import _VariationalStrategy
from .variational_strategy import VariationalStrategy, _joint_prior


class CiqVariationalStrategy(_VariationalStrategy):
    prior_distribution = VariationalStrategy.prior_distribution  # the whitened N(0, I)

    def forward(self, x, inducing_points, inducing_values, variational_inducing_covar=None, model=None, **kwargs):
        model = self._resolve_model(model)
        _, test_mean, K_ZZ, K_Zx, K_xx = _joint_prior(model, inducing_points, x)
        with settings.max_preconditioner_size(0):
            interp = sqrt_inv_matmul(K_ZZ.evaluate_kernel().add_jitter(self.jitter_val),
                                     K_Zx.evaluate_kernel().to_dense())  # (..., m, n)
        pred_mean = (interp.mT @ inducing_values.unsqueeze(-1)).squeeze(-1) + test_mean
        parts = [K_xx]
        if variational_inducing_covar is not None:
            parts.append(RootLinearOperator(interp.mT @ variational_inducing_covar.root_decomposition().root))
        return MultivariateNormal(pred_mean, SumLinearOperator(*parts, RootLinearOperator(interp.mT) * -1.0))
