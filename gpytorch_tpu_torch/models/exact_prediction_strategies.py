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

``InterpolatedPredictionStrategy`` (KISS-GP, a ``GridInterpolationKernel``) holds its
caches in inducing space: the mean c = K_UU Wᵀ (K̂)⁻¹(y − μ), so that μ* = W* c + μ*; the
LOVE root K_UU Wᵀ R; and the sampling root S with S Sᵀ ≈ K_UU − (K_UU Wᵀ R)(K_UU Wᵀ R)ᵀ,
which serves every test batch.  Its fantasy updates promote it to
``WiskiPredictionStrategy``, whose caches depend on the data only through WᵀW and Wᵀr
(dense m × m: it is meant for grids of a few thousand points).

``LinearPredictionStrategy`` (an ``RFFKernel``'s) holds its caches in feature space, for a
training covariance Φ Φᵀ + σ²I; ``SGPRPredictionStrategy`` (an ``InducingPointKernel``'s) is
the default strategy on R Rᵀ + σ²I.

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
default uses it ``detached()``.  Its LOVE caches too are built with their history: the
inverse root R through its block-Lanczos run on the training operator, and under
``fast_pred_samples`` the sample root R_s through its run on K** − (K*x R)(K*x R)ᵀ, as the
JAX package differentiates through both (``solvers/lanczos.py``).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional

import torch

from .. import settings
from ..distributions import MultitaskMultivariateNormal, MultivariateNormal
from ..linop import (AddedDiagLinearOperator, DenseLinearOperator, DiagLinearOperator, InterpolatedLinearOperator,
                     LazyEvaluatedKernelOperator, LowRankRootAddedDiagLinearOperator, MaskedLinearOperator,
                     RootLinearOperator, ZeroLinearOperator, to_linear_operator)
from ..ops.interp import left_interp, left_t_interp, segment_sum
from ..solvers.cholesky import psd_safe_cholesky


def prediction_strategy(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init=None):
    """The kernel's preferred strategy: the default one, KISS-GP's, SGPR's or the feature-space
    one of random Fourier features."""
    covar = train_prior_dist.lazy_covariance_matrix
    if isinstance(covar, LazyEvaluatedKernelOperator):
        return covar.kernel.prediction_strategy(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init)
    return DefaultPredictionStrategy(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init)


def _detached_operator(op):
    tensors, rebuild = op._flatten()
    return rebuild([t.detach() for t in tensors])


class DefaultPredictionStrategy:
    """The caches of a batched model hold one solve or root per batch element.  A
    multitask model's targets (n, t) are flattened to its distribution's layout
    (``gpytorch_tpu/models/exact_prediction_strategies.py:55-64``).  The likelihood's
    marginal over the training data is given the training inputs, whose column 0 a
    Hadamard likelihood reads its task indices from."""

    def __init__(self, train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init: Optional[torch.Tensor] = None):
        self.train_inputs = train_inputs
        self.train_prior_dist = train_prior_dist
        if isinstance(train_prior_dist, MultitaskMultivariateNormal) and train_labels.ndim >= 2:
            train_labels = train_prior_dist._task_to_flat(train_labels)
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
        self.lik_train_train_covar = likelihood.marginal(train_prior_dist, *train_inputs).lazy_covariance_matrix.evaluate_kernel()

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

    def build_caches(self) -> None:
        """Build what a request reads: the mean cache and, under ``fast_pred_var`` or
        ``fast_pred_samples``, the LOVE cache."""
        self.mean_cache
        if settings.fast_pred_var.on() or settings.fast_pred_samples.on():
            self.covar_cache

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
            with self._grad_mode():
                self._covar_cache = self.lik_train_train_covar.root_inv_decomposition(self.lanczos_init).root
        return self._covar_cache

    def exact_prediction(self, joint_mean, joint_covar):
        n = self.num_train
        test_mean = joint_mean[..., n:]
        if joint_covar.shape[-1] <= settings.max_eager_kernel_size.value():
            dense = joint_covar.to_dense()
            test_test_covar = DenseLinearOperator(dense[..., n:, n:])
            test_train_covar = DenseLinearOperator(dense[..., n:, :n])
        else:
            test_test_covar = joint_covar[..., n:, n:]
            test_train_covar = joint_covar[..., n:, :n]
        return (
            self.exact_predictive_mean(test_mean, test_train_covar),
            self.exact_predictive_covar(test_test_covar, test_train_covar),
        )

    def exact_predictive_mean(self, test_mean, test_train_covar):
        """μ* = K*x (K + σ²I)⁻¹(y − μ) + μ(x*)."""
        return to_linear_operator(test_train_covar).matmul(self.mean_cache.unsqueeze(-1)).squeeze(-1) + test_mean

    def exact_predictive_covar(self, test_test_covar, test_train_covar):
        if settings.skip_posterior_variances.on():
            shape = test_test_covar.shape[:-1]
            return DiagLinearOperator(torch.zeros(shape, dtype=self.train_labels.dtype, device=self.train_labels.device))
        if settings.fast_pred_samples.on():
            # LOVE sampling: the Lanczos root of Σ* = K** − (K*x R)(K*x R)ᵀ, built once a
            # request; without gradients unless the strategy keeps its history (the JAX
            # package detaches it under detach_test_caches)
            with self._grad_mode():
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

    def get_fantasy_strategy(self, inputs, targets, full_inputs, full_targets, full_output,
                             **kwargs) -> "DefaultPredictionStrategy":
        """The strategy of the model conditioned on m new observations (``inputs``,
        ``targets``), by the block-Schur identity
        (``gpytorch_tpu/models/exact_prediction_strategies.py:153-194``):

          [[Â, B ], [u]   [r₁]        v = S⁻¹(r₂ − Bᵀ u_old),  S = D − Bᵀ Â⁻¹ B,
           [Bᵀ, D]] [v] = [r₂]  ⇒     u = u_old − (Â⁻¹B) v,

        per batch element, with B = K(X, X_new) and D = K(X_new, X_new) + Σ_new evaluated
        densely from ``full_output`` (the prior over the joint inputs): m solves against the
        old system Â and an m×m ``psd_safe_cholesky``.  Σ_new is the likelihood's noise
        over the new points: ``noise`` (a fixed-noise likelihood's new observations'
        noise, given as a keyword) where it is given.  The new strategy's likelihood is the
        likelihood's ``get_fantasy_likelihood(**kwargs)`` where it has one.  The new mean
        cache is [u, v]; the new LOVE cache is left to be computed at first use on the
        (n + m) joint operator.  A multitask model takes no Schur update: its new strategy
        builds its caches at first use on the joint operator, as in the JAX package.  The
        solves run at the ambient ``cg_tolerance``, as in the JAX package.  Built with
        autograd where this strategy was."""
        lik = self.likelihood
        if hasattr(lik, "get_fantasy_likelihood"):
            lik = lik.get_fantasy_likelihood(**kwargs)
        with self._grad_mode():
            new = DefaultPredictionStrategy(full_inputs, full_output, full_targets, lik)
            if isinstance(full_output, MultitaskMultivariateNormal):
                return new
            n = self.num_train
            prior_joint = full_output.lazy_covariance_matrix
            # lazy slicing slices the inputs: an (n, m) and an (m, m) kernel evaluation
            B = prior_joint[..., :n, n:].to_dense()
            new_block = MultivariateNormal(full_output.loc[..., n:], prior_joint[..., n:, n:].evaluate_kernel())
            noise = {"noise": kwargs["noise"]} if "noise" in kwargs else {}
            D = lik.marginal(new_block, **noise).lazy_covariance_matrix.to_dense()
            u_old = self.mean_cache.unsqueeze(-1)
            AinvB = self.lik_train_train_covar.solve(B)
            S = D - B.mT @ AinvB
            resid = (full_targets[..., n:] - new_block.loc).unsqueeze(-1) - B.mT @ u_old
            v = torch.cholesky_solve(resid, psd_safe_cholesky(S))
            new._mean_cache = torch.cat([u_old - AinvB @ v, v], -2).squeeze(-1)
        return new


class InterpolatedPredictionStrategy(DefaultPredictionStrategy):
    """KISS-GP prediction with caches in inducing space
    (``gpytorch_tpu/models/exact_prediction_strategies.py:197-323``).  The training
    covariance is W K_UU Wᵀ + σ²I; a request interpolates its test points (W*) and reads:

    * ``interp_mean_cache`` c = K_UU Wᵀ (K̂)⁻¹(y − μ) (m, 1): μ* = W* c + μ(x*);
    * ``interp_covar_cache`` K_UU Wᵀ R (m, k), R the LOVE inverse root of K̂: under
      ``fast_pred_var`` Σ* = W* K_UU W*ᵀ − (W* K_UU Wᵀ R)(W* K_UU Wᵀ R)ᵀ;
    * ``interp_sample_cache`` S (m, k) with S Sᵀ ≈ K_UU − (K_UU Wᵀ R)(K_UU Wᵀ R)ᵀ, a Lanczos
      root: under ``fast_pred_samples`` Σ* = (W* S)(W* S)ᵀ, for any test batch;
    * otherwise the exact Σ* = W* K_UU W*ᵀ − K*x K̂⁻¹ Kx*, one CG solve with a column per
      test point.

    The training interpolation is evaluated afresh where a cache is built, as in the JAX
    package."""

    def __init__(self, train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init=None):
        super().__init__(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init)
        self._interp_mean_cache = None
        self._interp_covar_cache = None
        self._interp_sample_cache = None

    def detached(self):
        new = super().detached()
        for name in ("_interp_mean_cache", "_interp_covar_cache", "_interp_sample_cache"):
            value = getattr(self, name)
            setattr(new, name, None if value is None else value.detach())
        return new

    def build_caches(self) -> None:
        self.interp_mean_cache
        if settings.fast_pred_samples.on():
            self.interp_sample_cache
        elif self._love_variances():
            self.interp_covar_cache

    def _love_variances(self) -> bool:
        """Whether a request's variances come from ``interp_covar_cache`` (LOVE) rather than
        the exact branch."""
        return settings.fast_pred_var.on()

    def _train_interp(self) -> InterpolatedLinearOperator:
        covar = self.train_prior_dist.lazy_covariance_matrix.evaluate_kernel()
        if isinstance(covar, AddedDiagLinearOperator):
            covar = covar.base
        if not isinstance(covar, InterpolatedLinearOperator):
            raise RuntimeError("InterpolatedPredictionStrategy requires an interpolated covariance")
        return covar

    @property
    def interp_mean_cache(self) -> torch.Tensor:
        if self._interp_mean_cache is None:
            with self._grad_mode():
                interp = self._train_interp()
                wt = left_t_interp(interp.left_interp_indices, interp.left_interp_values,
                                   self.mean_cache.unsqueeze(-1), interp.base.shape[-1])
                self._interp_mean_cache = interp.base.matmul(wt)
        return self._interp_mean_cache

    @property
    def interp_covar_cache(self) -> torch.Tensor:
        if self._interp_covar_cache is None:
            with self._grad_mode():
                interp = self._train_interp()
                wt_root = left_t_interp(interp.left_interp_indices, interp.left_interp_values, self.covar_cache,
                                        interp.base.shape[-1])
                self._interp_covar_cache = interp.base.matmul(wt_root)
        return self._interp_covar_cache

    @property
    def interp_sample_cache(self) -> torch.Tensor:
        if self._interp_sample_cache is None:
            with self._grad_mode():
                base = self._train_interp().base
                inside = (base + RootLinearOperator(self.interp_covar_cache) * -1.0).evaluate_kernel()
                self._interp_sample_cache = inside.root_decomposition(method="lanczos").root
        return self._interp_sample_cache

    def exact_prediction(self, joint_mean, joint_covar):
        n = self.num_train
        joint = joint_covar.evaluate_kernel() if isinstance(joint_covar, LazyEvaluatedKernelOperator) else joint_covar
        if not isinstance(joint, InterpolatedLinearOperator):
            return super().exact_prediction(joint_mean, joint_covar)
        idx, val = joint.left_interp_indices[..., n:, :], joint.left_interp_values[..., n:, :]
        mean = left_interp(idx, val, self.interp_mean_cache).squeeze(-1) + joint_mean[..., n:]
        return mean, self._interp_predictive_covar(joint, idx, val, mean.shape)

    def _interp_predictive_covar(self, joint, idx, val, shape):
        if settings.skip_posterior_variances.on():
            return DiagLinearOperator(torch.zeros(shape, dtype=val.dtype, device=val.device))
        test_test = InterpolatedLinearOperator(joint.base, idx, val)
        if settings.fast_pred_samples.on():
            return RootLinearOperator(left_interp(idx, val, self.interp_sample_cache))
        if self._love_variances():
            root = left_interp(idx, val, self.interp_covar_cache)
            return (test_test + RootLinearOperator(root) * -1.0).evaluate_kernel()
        n = self.num_train
        test_train = InterpolatedLinearOperator(joint.base, idx, val, joint.right_interp_indices[..., :n, :],
                                                joint.right_interp_values[..., :n, :]).to_dense()
        correction = test_train @ self.lik_train_train_covar.solve(test_train.mT)
        return DenseLinearOperator(test_test.to_dense() - correction)

    def get_fantasy_strategy(self, inputs, targets, full_inputs, full_targets, full_output, **kwargs):
        """Fantasy updates promote the strategy to WISKI: WᵀW and Wᵀr built once from the
        training data (O(n q²)), then each update adds the new points' terms."""
        _unbatched_wiski(kwargs, self.train_labels)
        return WiskiPredictionStrategy.from_interpolated(self).get_fantasy_strategy(
            inputs, targets, full_inputs, full_targets, full_output, **kwargs)


def _unbatched_wiski(kwargs, train_labels) -> None:
    if kwargs or train_labels.ndim > 1:
        raise NotImplementedError("WISKI updates of a fixed-noise or batched KISS-GP model are not ported")


def _wtw_wtr(idx: torch.Tensor, vals: torch.Tensor, r: torch.Tensor, m: int):
    """WᵀW (m × m) and Wᵀr (m,) from the sparse interpolation rows, both deterministic
    segment sums (``ops/interp.py``)."""
    outer = (vals.unsqueeze(-1) * vals.unsqueeze(-2)).reshape(-1, 1)
    flat = (idx.unsqueeze(-1) * m + idx.unsqueeze(-2)).reshape(-1)
    wtw = segment_sum(flat, outer, m * m).reshape(m, m)
    return wtw, left_t_interp(idx, vals, r.unsqueeze(-1), m).squeeze(-1)


class WiskiPredictionStrategy(InterpolatedPredictionStrategy):
    """WISKI online updates (``gpytorch_tpu/models/exact_prediction_strategies.py:338-425``;
    Stanton et al., arXiv 2103.01454).  For K̂ = W K_UU Wᵀ + σ²I,

      Wᵀ K̂⁻¹ r = (WᵀW K_UU + σ²I)⁻¹ Wᵀr,   Wᵀ K̂⁻¹ W = (WᵀW K_UU + σ²I)⁻¹ WᵀW,

    so the posterior depends on the data only through WᵀW and Wᵀr, to which an update adds
    the new points' terms: no work in n per update.  The caches are dense in m: the mean
    c = K_UU (WᵀW K_UU + σ²I)⁻¹ Wᵀr and the Cholesky factor of
    P = K_UU (WᵀW K_UU + σ²I)⁻¹ WᵀW K_UU, so that Σ* = W* (K_UU − P) W*ᵀ."""

    def __init__(self, train_inputs, train_prior_dist, train_labels, likelihood, wtw, wtr, noise, lanczos_init=None):
        super().__init__(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init)
        self.wtw = wtw
        self.wtr = wtr
        self.noise = noise

    def detached(self):
        new = super().detached()
        new.wtw, new.wtr, new.noise = self.wtw.detach(), self.wtr.detach(), self.noise.detach()
        return new

    def _m_system(self):
        Kuu = self._train_interp().base.to_dense()
        eye = torch.eye(Kuu.shape[-1], dtype=Kuu.dtype, device=Kuu.device)
        return self.wtw @ Kuu + self.noise * eye, Kuu

    @property
    def interp_mean_cache(self) -> torch.Tensor:
        if self._interp_mean_cache is None:
            with self._grad_mode():
                M, Kuu = self._m_system()
                self._interp_mean_cache = Kuu @ torch.linalg.solve(M, self.wtr.unsqueeze(-1))
        return self._interp_mean_cache

    @property
    def interp_covar_cache(self) -> torch.Tensor:
        if self._interp_covar_cache is None:
            with self._grad_mode():
                M, Kuu = self._m_system()
                P = Kuu @ torch.linalg.solve(M, self.wtw @ Kuu)
                self._interp_covar_cache = psd_safe_cholesky(0.5 * (P + P.mT))
        return self._interp_covar_cache

    def _love_variances(self) -> bool:
        # the WISKI root of K_UU − P is exact in inducing space: every request reads it
        return True

    def get_fantasy_strategy(self, inputs, targets, full_inputs, full_targets, full_output, **kwargs):
        """Interpolate the new points and add their WᵀW and Wᵀr terms."""
        _unbatched_wiski(kwargs, self.train_labels)
        with self._grad_mode():
            joint = full_output.lazy_covariance_matrix.evaluate_kernel()
            n_new = targets.shape[-1]
            idx, val = joint.left_interp_indices[-n_new:], joint.left_interp_values[-n_new:]
            d_wtw, d_wtr = _wtw_wtr(idx, val, targets - full_output.loc[-n_new:], self.wtw.shape[-1])
            return WiskiPredictionStrategy(full_inputs, full_output, full_targets, self.likelihood,
                                           self.wtw + d_wtw, self.wtr + d_wtr, self.noise)

    @classmethod
    def from_interpolated(cls, strategy: InterpolatedPredictionStrategy) -> "WiskiPredictionStrategy":
        """WᵀW and Wᵀ(y − μ) of the training data, built once."""
        with strategy._grad_mode():
            interp = strategy._train_interp()
            r = strategy.train_labels - strategy.train_prior_dist.loc
            wtw, wtr = _wtw_wtr(interp.left_interp_indices, interp.left_interp_values, r, interp.base.shape[-1])
            noise = strategy.likelihood.noise.reshape(-1)[0]
            return cls(strategy.train_inputs, strategy.train_prior_dist, strategy.train_labels, strategy.likelihood,
                       wtw, wtr, noise, strategy.lanczos_init)


class LinearPredictionStrategy(DefaultPredictionStrategy):
    """Prediction in feature space for K = Φ Φᵀ (an ``RFFKernel``'s root Φ, n × k)
    (``gpytorch_tpu/models/exact_prediction_strategies.py:431-499``): with σ² the likelihood's
    first noise value and G = ΦᵀΦ + σ²I (k × k, a Cholesky factor L_G),

      mean cache  w = G⁻¹ Φᵀ(y − μ),             μ* = φ*ᵀ w + μ(x*),
      covar cache R = σ L_G⁻ᵀ (R Rᵀ = σ² G⁻¹),    Σ* = (φ*ᵀ R)(φ*ᵀ R)ᵀ,

    O(n k²) once and O(k²) a test point, no n × n solve.  Where the training covariance holds
    no root (a ``ScaleKernel`` around the features scales the operator, as in the JAX
    package), it serves by the default strategy."""

    def __init__(self, train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init=None):
        super().__init__(train_inputs, train_prior_dist, train_labels, likelihood, lanczos_init)
        self._feat_mean_cache = None
        self._feat_covar_root = None

    def detached(self):
        new = super().detached()
        for name in ("_feat_mean_cache", "_feat_covar_root"):
            value = getattr(self, name)
            setattr(new, name, None if value is None else value.detach())
        return new

    @staticmethod
    def _root_of(covar) -> Optional[torch.Tensor]:
        """The features Φ of a root operator, also under added noise; None for any other."""
        covar = covar.evaluate_kernel()
        if isinstance(covar, AddedDiagLinearOperator):
            covar = covar.base.evaluate_kernel()
        if isinstance(covar, LowRankRootAddedDiagLinearOperator):
            covar = covar.low_rank
        return covar.root if isinstance(covar, RootLinearOperator) else None

    def build_caches(self) -> None:
        if self._feature_caches()[0] is None:
            super().build_caches()

    def _feature_caches(self):
        if self._feat_mean_cache is None:
            phi = self._root_of(self.train_prior_dist.lazy_covariance_matrix)
            if phi is None:
                return None, None
            with self._grad_mode():
                sigma2 = self.likelihood.noise.reshape(-1)[0]
                eye = torch.eye(phi.shape[-1], dtype=phi.dtype, device=phi.device)
                L = psd_safe_cholesky(phi.mT @ phi + sigma2 * eye)
                diff = (self.train_labels - self.likelihood.marginal(self.train_prior_dist).loc).unsqueeze(-1)
                self._feat_mean_cache = torch.cholesky_solve(phi.mT @ diff, L)
                self._feat_covar_root = torch.sqrt(sigma2) * torch.linalg.solve_triangular(L.mT, eye, upper=True)
        return self._feat_mean_cache, self._feat_covar_root

    def exact_prediction(self, joint_mean, joint_covar):
        phi_joint = self._root_of(joint_covar)
        w, R = self._feature_caches()
        if phi_joint is None or w is None:
            return super().exact_prediction(joint_mean, joint_covar)
        n = self.num_train
        phi_test = phi_joint[..., n:, :]
        pred_mean = (phi_test @ w).squeeze(-1) + joint_mean[..., n:]
        if settings.skip_posterior_variances.on():
            m = phi_test.shape[-2]
            return pred_mean, ZeroLinearOperator(m, m, dtype=phi_test.dtype, device=phi_test.device)
        return pred_mean, RootLinearOperator(phi_test @ R)


class SGPRPredictionStrategy(DefaultPredictionStrategy):
    """SGPR (``gpytorch_tpu/models/exact_prediction_strategies.py:502``): the default
    strategy on the training covariance R Rᵀ + σ²I of an ``InducingPointKernel``.  As in the
    JAX package the low-rank root adds no algebra of its own: the mean cache is CG (or a dense
    Cholesky factor up to ``max_cholesky_size``), the LOVE cache block Lanczos, each through
    products R(Rᵀv)."""
