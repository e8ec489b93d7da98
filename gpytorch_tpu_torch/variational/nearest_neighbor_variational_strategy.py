"""VNNGP, the variational nearest-neighbour GP (Wu et al. 2022, arXiv 2202.01694).
Counterpart of ``gpytorch_tpu/variational/nearest_neighbor_variational_strategy.py``.

Every observed input is an inducing point, and q(u) = Π_j q(u_j | u_{n(j)}) with n(j) the k
nearest *preceding* inducing points (``nn_xinduce_idx``, built once by the strategy's
``NNUtil``, or ``IVFNNUtil`` with ``preferred_nnlib="ivf"``), so that the ELBO factorises
over inducing points and observations: every term is a k × k solve, batched over a
minibatch.  The prior over all M inducing points is never formed, only its mean and the
k × k (or (k + 1) × (k + 1)) blocks of each term.

As in the JAX package there is no hidden iterator state: training calls pass the minibatch's
positions in the inducing set as ``indices`` (all M by default), and the stochastic KL
takes explicit ``kl_indices`` in [k, M):

    KL ≈ KL(first k) + (M − k)/|B| Σ_{j ∈ B} KL_j.

Only a ``MeanFieldVariationalDistribution`` and unbatched inducing points are supported.
In eval mode a prediction conditions each test point on its k nearest inducing values.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..distributions import MultivariateNormal, kl_divergence
from ..linop import DiagLinearOperator
from ..solvers.cholesky import psd_safe_cholesky
from ..utils.nearest_neighbors import IVFNNUtil, NNUtil
from ._variational_distribution import MeanFieldVariationalDistribution, _assign
from ._variational_strategy import _VariationalStrategy


class NNVariationalStrategy(_VariationalStrategy):
    """``generator`` seeds the IVF index's k-means (``IVFNNUtil``)."""

    def __init__(self, model, inducing_points: torch.Tensor, variational_distribution, k: int,
                 training_batch_size: Optional[int] = None, jitter_val: float = 1e-3, compute_full_kl: bool = False,
                 preferred_nnlib: str = "exact", generator: Optional[torch.Generator] = None):
        if not isinstance(variational_distribution, MeanFieldVariationalDistribution):
            raise RuntimeError("NNVariationalStrategy only supports MeanFieldVariationalDistribution")
        if inducing_points.ndim == 1:
            inducing_points = inducing_points.unsqueeze(-1)
        if inducing_points.ndim != 2:
            raise NotImplementedError("NNVariationalStrategy supports unbatched inducing points")
        super().__init__(model, inducing_points, variational_distribution, learn_inducing_locations=False,
                         jitter_val=jitter_val)
        self.M, self.D = inducing_points.shape
        self.k = int(k)
        if self.k >= self.M:
            raise ValueError(f"k must be smaller than the number of inducing points ({self.M}), got {k}")
        self.compute_full_kl = bool(compute_full_kl)
        self.training_batch_size = int(training_batch_size) if training_batch_size else self.M
        if preferred_nnlib == "ivf":
            self.nn_util = IVFNNUtil(self.k, dim=self.D, generator=generator)
        elif preferred_nnlib == "exact":
            self.nn_util = NNUtil(self.k, dim=self.D)
        else:
            raise ValueError(f"preferred_nnlib must be 'exact' or 'ivf', got {preferred_nnlib!r}")
        self.nn_util.set_nn_idx(self.inducing_points)
        self.register_buffer("nn_xinduce_idx", self.nn_util.build_sequential_nn_idx(self.inducing_points))

    def _apply(self, fn, *args, **kwargs):
        # the index follows the module's buffers (its inputs and an IVF index's tensors)
        out = super()._apply(fn, *args, **kwargs)
        self.nn_util.train_x = self.inducing_points
        if getattr(self.nn_util, "_index", None) is not None:
            self.nn_util._index = {name: fn(t) for name, t in self.nn_util._index.items()}
        return out

    def prior_distribution(self, model=None) -> MultivariateNormal:
        """N(μ_Z, K_ZZ + jitter) over all M points, its covariance a lazy operator (read only
        where a caller asks for it)."""
        out = self._resolve_model(model).forward(self.inducing_points)
        return MultivariateNormal(out.loc, out.lazy_covariance_matrix.evaluate_kernel().add_jitter(self.jitter_val))

    def _maybe_initialize(self, model) -> None:
        """q(u) from the prior, then a standard deviation of 1e-2 (GPyTorch's initial value,
        for a faster KL).  The prior's variance is its diagonal."""
        if int(self.variational_params_initialized) == 0:
            vd = self._variational_distribution
            with torch.no_grad():
                vd.initialize_variational_distribution(self.prior_distribution(model))
                _assign(vd.raw_variational_stddev, torch.full_like(vd.raw_variational_stddev, 1e-2))
            self.variational_params_initialized.fill_(1)

    def __call__(self, x, prior: bool = False, model=None, indices=None, **kwargs):
        model = self._resolve_model(model)
        if prior:
            return model.forward(x)
        self._maybe_initialize(model)
        vd = self._variational_distribution
        if self.training:
            # q(f_i) = q(u_{idx(i)}): the observations are the inducing points
            if indices is None:
                if x is not None and x.shape[-2] != self.M:
                    indices = self.nn_util.find_nn_idx(x, k=1)[..., 0]
                else:
                    indices = torch.arange(self.M, device=self.inducing_points.device)
            return MultivariateNormal(vd.variational_mean[..., indices],
                                      DiagLinearOperator(vd.variational_stddev[..., indices] ** 2))
        return self._predict(x.unsqueeze(-1) if x.ndim == 1 else x, model)

    def _conditional(self, model, Z_nn: torch.Tensor, z: torch.Tensor):
        """(μ_nn, μ_z, K_nn + jitter, k_nz, k_zz) from one prior over each row's [n(·), z]."""
        full = model.forward(torch.cat([Z_nn, z.unsqueeze(-2)], -2))
        mean, covar = full.loc, full.lazy_covariance_matrix.to_dense()
        k = self.k
        K_nn = covar[..., :k, :k] + self.jitter_val * torch.eye(k, dtype=covar.dtype, device=covar.device)
        return mean[..., :k], mean[..., k], K_nn, covar[..., :k, k], covar[..., k, k]

    def _predict(self, x: torch.Tensor, model) -> MultivariateNormal:
        """p(f* | u_{n(*)}) with each test point's k nearest inducing points."""
        vd = self._variational_distribution
        nn_idx = self.nn_util.find_nn_idx(x)  # (n, k)
        mu_nn, mu_x, K_nn, k_nx, k_xx = self._conditional(model, self.inducing_points[nn_idx], x)
        interp = torch.cholesky_solve(k_nx.unsqueeze(-1), psd_safe_cholesky(K_nn)).squeeze(-1)  # K_nn⁻¹ k_nx
        pred_mean = mu_x + (interp * (vd.variational_mean[nn_idx] - mu_nn)).sum(-1)
        pred_var = (k_xx - (interp * k_nx).sum(-1) + (interp ** 2 * vd.variational_stddev[nn_idx] ** 2).sum(-1))
        return MultivariateNormal(pred_mean, DiagLinearOperator(pred_var.clamp_min(1e-10)))

    def _firstk_kl_helper(self, model) -> torch.Tensor:
        """The exact KL over the first k inducing points."""
        out = model.forward(self.inducing_points[:self.k])
        prior = MultivariateNormal(out.loc, out.lazy_covariance_matrix.evaluate_kernel().add_jitter(self.jitter_val))
        vd = self._variational_distribution
        q = MultivariateNormal(vd.variational_mean[..., :self.k],
                               DiagLinearOperator(vd.variational_stddev[..., :self.k] ** 2))
        return kl_divergence(q, prior)

    def _stochastic_kl_helper(self, kl_indices: torch.Tensor, model) -> torch.Tensor:
        """Σ_{j ∈ B} KL(q(u_j | u_{n(j)}) ‖ p(u_j | u_{n(j)})) for j ≥ k: with
        B_j = K_{n(j)n(j)}⁻¹ k_{n(j)j} and F_j = k_jj − k_{jn(j)} B_j + jitter, each term is
        ½[log F_j − log s_j − 1 + (Σ_l B_jl² s_{n(j)l} + s_j)/F_j
          + (m_j − μ_j − B_jᵀ(m_{n(j)} − μ_{n(j)}))²/F_j]."""
        vd = self._variational_distribution
        nn_idx = self.nn_xinduce_idx[kl_indices - self.k]  # (b, k)
        mu_nn, mu_j, K_nn, k_nj, k_jj = self._conditional(model, self.inducing_points[nn_idx],
                                                          self.inducing_points[kl_indices])
        B = torch.cholesky_solve(k_nj.unsqueeze(-1), psd_safe_cholesky(K_nn)).squeeze(-1)
        F = k_jj - (B * k_nj).sum(-1) + self.jitter_val
        s_j, m_j = vd.variational_stddev[..., kl_indices] ** 2, vd.variational_mean[..., kl_indices]
        s_nn, m_nn = vd.variational_stddev[..., nn_idx] ** 2, vd.variational_mean[..., nn_idx]
        trace = ((B ** 2 * s_nn).sum(-1) + s_j) / F
        mean_term = (m_j - mu_j - (B * (m_nn - mu_nn)).sum(-1)) ** 2 / F
        return 0.5 * (torch.log(F) - torch.log(s_j) - 1.0 + trace + mean_term).sum(-1)

    def kl_divergence(self, model=None, kl_indices=None) -> torch.Tensor:
        """The stochastic estimate with ``kl_indices``, else the full KL over all M points."""
        model = self._resolve_model(model)
        kl = self._firstk_kl_helper(model)
        if kl_indices is not None:
            return kl + (self.M - self.k) / kl_indices.shape[0] * self._stochastic_kl_helper(kl_indices, model)
        if self.M > self.k:
            kl = kl + self._stochastic_kl_helper(torch.arange(self.k, self.M, device=self.inducing_points.device),
                                                 model)
        return kl

    def get_fantasy_model(self, inputs, targets, **kwargs):
        raise NotImplementedError("No fantasy model support for NNVariationalStrategy")
