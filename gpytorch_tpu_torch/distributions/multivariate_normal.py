"""MultivariateNormal backed by a lazy covariance operator.

Counterpart of ``gpytorch_tpu/distributions/multivariate_normal.py`` as far as serving
and training need it: ``mean``, ``variance`` (the lazy diagonal, floored at
``settings.min_variance``), ``lazy_covariance_matrix`` and ``log_prob`` by mBCG.
"""

from __future__ import annotations

import math

import torch

from .. import settings
from ..linop import LinearOperator, to_linear_operator


class MultivariateNormal:
    def __init__(self, mean: torch.Tensor, covariance_matrix):
        self.loc = mean
        self._covar = to_linear_operator(covariance_matrix)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    @property
    def lazy_covariance_matrix(self) -> LinearOperator:
        return self._covar

    @property
    def covariance_matrix(self) -> torch.Tensor:
        return self._covar.to_dense()

    @property
    def variance(self) -> torch.Tensor:
        diag = self._covar._diagonal()
        return diag.clamp_min(settings.min_variance.value(diag.dtype))

    @property
    def event_shape(self) -> torch.Size:
        return self.loc.shape[-1:]

    def log_prob(self, value: torch.Tensor, base_samples=None, solver_state=None, return_state: bool = False):
        """log N(value; μ, K) by one mBCG ``inv_quad_logdet`` call, differentiable.

        ``base_samples`` is where the SLQ probes' base samples come from (a
        ``torch.Generator``, or a callable that returns them for a shape);
        ``solver_state``/``return_state`` carry the warm start of the rhs solve across
        training steps (``solvers/inv_quad.py``): with ``return_state`` the return is
        ``(log_prob, state)``."""
        diff = value - self.loc
        covar = self._covar.evaluate_kernel()
        res = covar.inv_quad_logdet(
            inv_quad_rhs=diff.unsqueeze(-1), logdet=True, base_samples=base_samples,
            solver_state=solver_state, return_state=return_state,
        )
        (inv_quad, logdet), state = res if return_state else (res, None)
        n = covar.shape[-1]
        lp = -0.5 * (inv_quad + logdet + n * math.log(2 * math.pi))
        return (lp, state) if return_state else lp
