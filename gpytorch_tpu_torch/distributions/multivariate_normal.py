"""MultivariateNormal backed by a lazy covariance operator.

Counterpart of ``gpytorch_tpu/distributions/multivariate_normal.py`` as far as serving,
training and sampling need it: ``mean``, ``variance`` (the lazy diagonal, floored at
``settings.min_variance``), ``lazy_covariance_matrix``, ``log_prob`` (by mBCG, or by a
dense Cholesky factor at most ``settings.max_cholesky_size`` points or with
``settings.fast_computations.log_prob`` off), and samples from the covariance's root
decomposition, whose base samples come from a ``torch.Generator`` or are injected, in
place of a JAX key.  A batched covariance (or mean) gives a batch of distributions: one
log-density per batch element.  ``expand`` repeats a distribution over a larger batch
without copying it, ``to_data_independent_dist`` is the ``torch.distributions.Normal`` of
its marginals, and ``kl_divergence`` is KL(p ‖ q) of two of them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .. import settings
from ..linop import LinearOperator, ProbeSource, probe_base_samples, to_linear_operator


class MultivariateNormal:
    def __init__(self, mean: torch.Tensor, covariance_matrix):
        self.loc = mean
        self._covar = to_linear_operator(covariance_matrix)

    @property
    def mean(self) -> torch.Tensor:
        batch = self.batch_shape
        return self.loc if self.loc.shape[:-1] == batch else self.loc.expand(batch + self.loc.shape[-1:])

    @property
    def batch_shape(self) -> torch.Size:
        return torch.broadcast_shapes(self.loc.shape[:-1], self._covar.batch_shape)

    @property
    def lazy_covariance_matrix(self) -> LinearOperator:
        return self._covar

    @property
    def covariance_matrix(self) -> torch.Tensor:
        return self._covar.to_dense()

    @property
    def variance(self) -> torch.Tensor:
        diag = self._covar._diagonal()
        diag = diag.expand(self.batch_shape + diag.shape[-1:])
        return diag.clamp_min(settings.min_variance.value(diag.dtype))

    @property
    def stddev(self) -> torch.Tensor:
        return self.variance.sqrt()

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
        diff = diff.expand(torch.broadcast_shapes(diff.shape[:-1], self.batch_shape) + diff.shape[-1:])
        covar = self._covar.evaluate_kernel()
        res = covar.inv_quad_logdet(
            inv_quad_rhs=diff.unsqueeze(-1), logdet=True, base_samples=base_samples,
            solver_state=solver_state, return_state=return_state,
        )
        (inv_quad, logdet), state = res if return_state else (res, None)
        n = covar.shape[-1]
        lp = -0.5 * (inv_quad + logdet + n * math.log(2 * math.pi))
        return (lp, state) if return_state else lp

    def rsample(self, sample_shape: Sequence[int] = (), base_samples: ProbeSource = None) -> torch.Tensor:
        """Samples of shape ``sample_shape`` + (n,): μ + R u from the covariance's root
        decomposition R, with u from ``base_samples`` (a ``torch.Generator``, or a callable
        that returns them for a shape)."""
        num = math.prod(sample_shape)
        samples = self._covar.evaluate_kernel().zero_mean_mvn_samples(num, base_samples) + self.loc
        return samples.reshape(tuple(sample_shape) + tuple(self.batch_shape) + self.loc.shape[-1:])

    def sample(self, sample_shape: Sequence[int] = (), base_samples: ProbeSource = None) -> torch.Tensor:
        with torch.no_grad():
            return self.rsample(sample_shape, base_samples)

    def get_base_samples(self, sample_shape: Sequence[int] = (), base_samples: ProbeSource = None) -> torch.Tensor:
        """Standard-normal draws of shape ``sample_shape`` + (k,), k the rank of the
        covariance's root decomposition, for ``rsample_from_base_samples``."""
        root = self._covar.evaluate_kernel().root_decomposition().root
        return probe_base_samples(tuple(sample_shape) + (root.shape[-1],), root.dtype, root.device, base_samples)

    def rsample_from_base_samples(self, base_samples: torch.Tensor) -> torch.Tensor:
        """μ + R u for base samples u of shape (..., k)."""
        root = self._covar.evaluate_kernel().root_decomposition().root
        return (root @ base_samples.unsqueeze(-1)).squeeze(-1) + self.loc

    def expand(self, batch_shape: Sequence[int]) -> "MultivariateNormal":
        batch_shape = tuple(batch_shape)
        covar = self._covar.expand(batch_shape + tuple(self._covar.shape[-2:]))
        return MultivariateNormal(self.loc.expand(batch_shape + self.loc.shape[-1:]), covar)

    def to_data_independent_dist(self) -> torch.distributions.Normal:
        """The independent normals of the marginals N(μ_i, σ²_i)."""
        return torch.distributions.Normal(self.mean, self.stddev, validate_args=False)


def kl_divergence(p: MultivariateNormal, q: MultivariateNormal) -> torch.Tensor:
    """KL(p ‖ q) = ½[tr(Σq⁻¹Σp) + (μq − μp)ᵀΣq⁻¹(μq − μp) − n + log|Σq| − log|Σp|], one value
    per batch element: the trace and the quadratic form are one ``inv_quad_logdet`` of Σq
    against [R_p | μq − μp] for a root R_p Rᵀ_p = Σp, so that a closed-form Σq (the whitened
    N(0, I) prior) stays closed form and a lazy kernel Σq (the unwhitened prior) runs one
    mBCG solve (``gpytorch_tpu/distributions/multivariate_normal.py:202-215``)."""
    n = p.event_shape[0]
    mean_diff = q.mean - p.mean
    q_covar = q.lazy_covariance_matrix.evaluate_kernel()
    p_covar = p.lazy_covariance_matrix.evaluate_kernel()
    rhs = torch.cat([p_covar.root_decomposition().root, mean_diff.unsqueeze(-1)], dim=-1)
    inv_quad, logdet_q = q_covar.inv_quad_logdet(inv_quad_rhs=rhs, logdet=True, reduce_inv_quad=True)
    return 0.5 * (inv_quad - n + logdet_q - p_covar.logdet())
