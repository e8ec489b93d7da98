"""Exact-GP posterior prediction with train-dependent caches.

Counterpart of ``DefaultPredictionStrategy`` in
``gpytorch_tpu/models/exact_prediction_strategies.py``:

* ``mean_cache`` = (K + σ²I)⁻¹(y − μ), one CG solve, with NaN targets treated by
  ``settings.observation_nan_policy`` ("mask": the solve is against
  ``MaskedLinearOperator``; "mask" and "fill": their entries of y − μ are zero);
* ``covar_cache`` = R with R Rᵀ ≈ (K + σ²I)⁻¹, the LOVE inverse root (block Lanczos);
* the predictive mean K*x·mean_cache + μ*, and under ``fast_pred_var`` the predictive
  covariance K** − (K*x R)(K*x R)ᵀ; under ``fast_pred_samples`` that covariance as its
  own Lanczos root R_s (R_s R_sᵀ ≈ K** − (K*x R)(K*x R)ᵀ), so that each draw is one
  product R_s u;
* ``get_fantasy_strategy``, the rank-m block-Schur update of the mean cache for m new
  observations (m solves against the old system and an m×m Cholesky factor).

Up to ``settings.max_cholesky_size`` training points both caches come from a dense
Cholesky factor instead (``LinearOperator.solve``, ``root_inv_decomposition``).

A strategy built under the default ``detach_test_caches`` is built without gradients:
its caches are plain tensors, and a prediction is differentiable with respect to its test
side (K*x, K** and μ*, hence the test inputs).  On the exact branch the training operator
carries no gradient and its solve is differentiated through the right-hand side K(x, x*),
so both symmetric terms of d(K*x (K + σ²I)⁻¹ Kx*) are kept.  (The JAX package detaches that
solve's result under this setting, which drops one of them and halves the gradient of the
exact variance.)

A strategy built under ``detach_test_caches(False)`` with autograd on (``with_graph``)
holds its training operator and caches with their autograd history: its solves are
differentiated through the operator as well (``linop/base.py::_Solve``).  The model uses
such a strategy for one call only (``spent``), so that no graph is shared by two
predictions; its history lives until the next call replaces it, and a call under the
default uses it ``detached()``.  The LOVE branches raise under that
setting: the JAX package differentiates through its Lanczos run, which is not ported.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional

import torch

from .. import settings
from ..distributions import MultivariateNormal
from ..linop import (DenseLinearOperator, DiagLinearOperator, LazyEvaluatedKernelOperator, MaskedLinearOperator,
                     RootLinearOperator, to_linear_operator)
from ..solvers.cholesky import psd_safe_cholesky


def prediction_strategy(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init=None):
    """The kernel's preferred strategy (the default one for every kernel of this port)."""
    covar = train_prior_dist.lazy_covariance_matrix
    if isinstance(covar, LazyEvaluatedKernelOperator):
        return covar.kernel.prediction_strategy(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init)
    return DefaultPredictionStrategy(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init)


def _detached_operator(op):
    tensors, rebuild = op._flatten()
    return rebuild([t.detach() for t in tensors])


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
        # built with autograd under detach_test_caches(False); the model uses it once
        self.with_graph = torch.is_grad_enabled() and settings.detach_test_caches.off()
        self.spent = False
        # marginal over the training data: K_XX + σ²I
        self.lik_train_train_covar = likelihood.marginal(train_prior_dist).lazy_covariance_matrix.evaluate_kernel()

    def _grad_mode(self):
        return contextlib.nullcontext() if self.with_graph else torch.no_grad()

    def detached(self) -> "DefaultPredictionStrategy":
        """The same strategy without autograd history: the same cached values."""
        new = copy.copy(self)
        prior = self.train_prior_dist
        new.train_prior_dist = MultivariateNormal(prior.loc.detach(), _detached_operator(prior.lazy_covariance_matrix))
        new.lik_train_train_covar = _detached_operator(self.lik_train_train_covar)
        new._mean_cache = None if self._mean_cache is None else self._mean_cache.detach()
        new._covar_cache = None if self._covar_cache is None else self._covar_cache.detach()
        new.with_graph = False
        return new

    @property
    def mean_cache(self) -> torch.Tensor:
        """(K + σ²I)⁻¹(y − μ), under ``settings.observation_nan_policy``
        (``gpytorch_tpu/models/exact_prediction_strategies.py:72-92``)."""
        if self._mean_cache is None:
            with self._grad_mode():
                diff = (self.train_labels - self.train_prior_dist.loc).unsqueeze(-1)
                covar = self.lik_train_train_covar
                nan_policy = settings.observation_nan_policy.value()
                if nan_policy != "ignore":
                    observed = ~torch.isnan(self.train_labels)
                    diff = torch.where(observed.unsqueeze(-1), diff, torch.zeros_like(diff))
                    if nan_policy == "mask":
                        covar = MaskedLinearOperator(covar, observed)
                self._mean_cache = covar.solve(diff).squeeze(-1)
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
        if (settings.fast_pred_var.on() or settings.fast_pred_samples.on()) and settings.detach_test_caches.off():
            raise NotImplementedError(
                "LOVE (fast_pred_var, fast_pred_samples) under detach_test_caches(False) is not ported: the JAX package "
                "differentiates through its Lanczos run"
            )
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

    def get_fantasy_strategy(self, inputs, targets, full_inputs, full_targets, full_output) -> "DefaultPredictionStrategy":
        """The strategy of the model conditioned on m new observations (``inputs``,
        ``targets``), by the block-Schur identity
        (``gpytorch_tpu/models/exact_prediction_strategies.py:153-194``):

          [[Â, B ], [u]   [r₁]        v = S⁻¹(r₂ − Bᵀ u_old),  S = D − Bᵀ Â⁻¹ B,
           [Bᵀ, D]] [v] = [r₂]  ⇒     u = u_old − (Â⁻¹B) v,

        with B = K(X, X_new) and D = K(X_new, X_new) + σ²I evaluated densely from
        ``full_output`` (the prior over the joint inputs): m solves against the old system
        Â and an m×m ``psd_safe_cholesky``.  The new mean cache is [u, v]; the new LOVE
        cache is left to be computed at first use on the (n + m) joint operator.  The
        solves run at the ambient ``cg_tolerance``, as in the JAX package.  Built with
        autograd where this strategy was."""
        with self._grad_mode():
            new = DefaultPredictionStrategy(full_inputs, full_output, full_targets, self.likelihood)
            n = self.num_train
            prior_joint = full_output.lazy_covariance_matrix
            # lazy slicing slices the inputs: an (n, m) and an (m, m) kernel evaluation
            B = prior_joint[:n, n:].to_dense()
            new_block = MultivariateNormal(full_output.loc[n:], prior_joint[n:, n:].evaluate_kernel())
            D = self.likelihood.marginal(new_block).lazy_covariance_matrix.to_dense()
            u_old = self.mean_cache
            AinvB = self.lik_train_train_covar.solve(B)
            S = D - B.mT @ AinvB
            resid = full_targets[n:] - new_block.loc - B.mT @ u_old
            v = torch.cholesky_solve(resid.unsqueeze(-1), psd_safe_cholesky(S)).squeeze(-1)
            u = u_old - AinvB @ v
            new._mean_cache = torch.cat([u, v], -1)
        return new
