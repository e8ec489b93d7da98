"""Exact-GP posterior prediction with train-dependent caches.

Counterpart of ``DefaultPredictionStrategy`` in
``gpytorch_tpu/models/exact_prediction_strategies.py``:

* ``mean_cache`` = (K + σ²I)⁻¹(y − μ), one CG solve;
* ``covar_cache`` = R with R Rᵀ ≈ (K + σ²I)⁻¹, the LOVE inverse root (block Lanczos);
* the predictive mean K*x·mean_cache + μ*, and under ``fast_pred_var`` the predictive
  covariance K** − (K*x R)(K*x R)ᵀ; under ``fast_pred_samples`` that covariance as its
  own Lanczos root R_s (R_s R_sᵀ ≈ K** − (K*x R)(K*x R)ᵀ), so that each draw is one
  product R_s u.

Up to ``settings.max_cholesky_size`` training points both caches come from a dense
Cholesky factor instead (``LinearOperator.solve``, ``root_inv_decomposition``).

Both caches are plain tensors built at first use, without gradients, and kept until the
model's caches are cleared.  The predictive mean and covariance are differentiable with
respect to the test side: K*x, K** and μ*, hence the test inputs.  The training operator
carries no gradient (the strategy is built under ``torch.no_grad()``); on the exact branch
its solve is differentiated through the right-hand side K(x, x*), so both symmetric terms
of d(K*x (K + σ²I)⁻¹ Kx*) are kept.  (The JAX package detaches that solve's result, which
drops one of them and halves the gradient of the exact variance.)
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import settings
from ..linop import DenseLinearOperator, DiagLinearOperator, LazyEvaluatedKernelOperator, RootLinearOperator
from ..linop import to_linear_operator


def prediction_strategy(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init=None):
    """The kernel's preferred strategy (the default one for every kernel of this port)."""
    covar = train_prior_dist.lazy_covariance_matrix
    if isinstance(covar, LazyEvaluatedKernelOperator):
        return covar.kernel.prediction_strategy(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init)
    return DefaultPredictionStrategy(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init)


class DefaultPredictionStrategy:
    def __init__(self, train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init: Optional[torch.Tensor] = None):
        self.train_inputs = train_inputs
        self.train_prior_dist = train_prior_dist
        self.train_labels = train_labels
        self.likelihood = likelihood
        # explicit start block of the LOVE Lanczos run (None: seeded CPU draw)
        self.lanczos_init = lanczos_init
        self._mean_cache = None
        self._covar_cache = None
        self.num_train = train_prior_dist.loc.shape[-1]
        # marginal over the training data: K_XX + σ²I
        self.lik_train_train_covar = likelihood.marginal(train_prior_dist).lazy_covariance_matrix.evaluate_kernel()

    @property
    def mean_cache(self) -> torch.Tensor:
        """(K + σ²I)⁻¹(y − μ)."""
        if self._mean_cache is None:
            with torch.no_grad():
                diff = (self.train_labels - self.train_prior_dist.loc).unsqueeze(-1)
                self._mean_cache = self.lik_train_train_covar.solve(diff).squeeze(-1)
        return self._mean_cache

    @property
    def covar_cache(self) -> torch.Tensor:
        """LOVE root R with R Rᵀ ≈ (K + σ²I)⁻¹."""
        if self._covar_cache is None:
            with torch.no_grad():
                self._covar_cache = self.lik_train_train_covar.root_inv_decomposition(self.lanczos_init).root
        return self._covar_cache

    def exact_prediction(self, joint_mean, joint_covar):
        n = self.num_train
        test_mean = joint_mean[..., n:]
        if joint_covar.shape[-1] <= settings.max_eager_kernel_size.value():
            dense = joint_covar.to_dense()
            test_test_covar = DenseLinearOperator(dense[n:, n:])
            test_train_covar = DenseLinearOperator(dense[n:, :n])
        else:
            test_test_covar = joint_covar[n:, n:]
            test_train_covar = joint_covar[n:, :n]
        return (
            self.exact_predictive_mean(test_mean, test_train_covar),
            self.exact_predictive_covar(test_test_covar, test_train_covar),
        )

    def exact_predictive_mean(self, test_mean, test_train_covar):
        """μ* = K*x (K + σ²I)⁻¹(y − μ) + μ(x*)."""
        return to_linear_operator(test_train_covar).matmul(self.mean_cache.unsqueeze(-1)).squeeze(-1) + test_mean

    def exact_predictive_covar(self, test_test_covar, test_train_covar):
        if settings.skip_posterior_variances.on():
            m = test_test_covar.shape[-1]
            return DiagLinearOperator(torch.zeros(m, dtype=self.train_labels.dtype, device=self.train_labels.device))
        if settings.fast_pred_samples.on():
            # LOVE sampling: the Lanczos root of Σ* = K** − (K*x R)(K*x R)ᵀ, built once a
            # request and without gradients (the JAX package detaches it)
            with torch.no_grad():
                posterior = test_test_covar + RootLinearOperator(test_train_covar.matmul(self.covar_cache)) * -1.0
                return RootLinearOperator(posterior.evaluate_kernel().root_decomposition(method="lanczos").root)
        if settings.fast_pred_var.on():
            # LOVE: Σ* = K** − (K*x R)(K*x R)ᵀ
            covar_inv_quad_form_root = test_train_covar.matmul(self.covar_cache)
            return (test_test_covar + RootLinearOperator(covar_inv_quad_form_root) * -1.0).evaluate_kernel()
        # exact: K** − K*x (K + σ²I)⁻¹ Kx*
        train_test = test_train_covar.to_dense()
        correction = train_test @ self.lik_train_train_covar.solve(train_test.mT)
        return DenseLinearOperator(test_test_covar.to_dense() - correction)
