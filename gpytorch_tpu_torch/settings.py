"""Global configuration context managers — the knobs exact-GP serving and training read.

Counterpart of ``gpytorch_tpu/settings.py`` (same class names, same defaults).  Each knob
is a class whose value is read at call time and set for a block with ``with``::

    with settings.max_cholesky_size(0), settings.fast_pred_var():
        pred = likelihood(model(test_x))

PyTorch runs eagerly, so a value read inside a solver is the value in force when that
solver runs.  The one exception is a backward pass, which runs after the caller's ``with``
block has exited: the training objective (``solvers/inv_quad.py``) snapshots the knobs it
needs when it is called, as the JAX package's ``_IQConfig`` does.
"""

from __future__ import annotations

from typing import Any, Optional

import torch


class _feature_flag:
    """On/off flag with a class default, usable as a context manager."""

    _default = False
    _state: Optional[bool] = None

    def __init__(self, state: bool = True):
        self.state = state

    @classmethod
    def on(cls) -> bool:
        return cls._default if cls._state is None else cls._state

    @classmethod
    def off(cls) -> bool:
        return not cls.on()

    def __enter__(self):
        self.prev = type(self)._state
        type(self)._state = self.state
        return self

    def __exit__(self, *exc):
        type(self)._state = self.prev
        return False


class _value_context:
    """Scalar-valued setting, usable as a context manager."""

    _global_value: Any = None

    def __init__(self, value):
        self._value = value

    @classmethod
    def value(cls):
        return cls._global_value

    def __enter__(self):
        self.prev = type(self)._global_value
        type(self)._global_value = self._value
        return self

    def __exit__(self, *exc):
        type(self)._global_value = self.prev
        return False


class _dtype_value_context:
    """Setting with one value per floating-point precision."""

    _global_float_value: Any = None
    _global_double_value: Any = None
    _global_half_value: Any = None

    @classmethod
    def value(cls, dtype: Optional[torch.dtype] = None):
        if dtype == torch.float64:
            return cls._global_double_value
        if dtype in (torch.float16, torch.bfloat16):
            return cls._global_half_value
        return cls._global_float_value


class max_cholesky_size(_value_context):
    """N at or below which a dense Cholesky factor replaces CG and Lanczos: in ``solve``,
    ``inv_quad_logdet`` and both root decompositions."""

    _global_value = 800


class solve_iterative_refinements(_value_context):
    """Passes of iterative refinement after each CG solve: x ← x + CG(A, b − A x), each
    against the residual of the solution so far.  One more CG solve a pass."""

    _global_value = 0


class cg_tolerance(_value_context):
    _global_value = 1.0


class eval_cg_tolerance(_value_context):
    """CG tolerance used for posterior inference (the mean cache solve)."""

    _global_value = 0.01


class max_cg_iterations(_value_context):
    _global_value = 1000


class cg_stall_window(_value_context):
    """Stop CG after this many iterations without improvement of the best residual."""

    _global_value = 10


class max_preconditioner_size(_value_context):
    """Rank of the pivoted-Cholesky preconditioner (0 disables it)."""

    _global_value = 15


class min_preconditioning_size(_value_context):
    """Operators smaller than this are solved without a preconditioner."""

    _global_value = 2000


class preconditioner_tolerance(_value_context):
    """Stop adding pivots once the residual trace is below this fraction of the original."""

    _global_value = 1e-3


class preconditioner_noise_budget(_value_context):
    """Relative accuracy budget of the preconditioner apply.  With a budget b > 0 the
    preconditioner is P = LLᵀ + max(D, τ)I with τ = λ_max(LLᵀ)·eps/b, which bounds
    cond(P) by b/eps and so bounds the float32 apply noise that would stall CG.
    0 disables the regularisation."""

    _global_value = 0.0


class max_root_decomposition_size(_value_context):
    """Rank of the LOVE (Lanczos) root decomposition."""

    _global_value = 100


class num_trace_samples(_value_context):
    """Probe vectors of the stochastic log-determinant estimate (SLQ)."""

    _global_value = 10


class max_lanczos_quadrature_iterations(_value_context):
    """Lanczos iterations of SLQ: the CG iteration floor of the training solve."""

    _global_value = 20


class num_contour_quadrature(_value_context):
    """Quadrature nodes (shifts) of contour-integral quadrature, K^{±1/2}·v (CIQ)."""

    _global_value = 15


class minres_tolerance(_value_context):
    """Relative residual of the unshifted system at which CIQ's multi-shift CG stops."""

    _global_value = 1e-4


class max_minres_iterations(_value_context):
    """Iteration cap of CIQ's multi-shift CG."""

    _global_value = 100


class ciq_samples(_feature_flag):
    """Draw N(0, K) samples as K^{1/2}ε by contour-integral quadrature instead of a root
    decomposition."""

    _default = False


class num_gauss_hermite_locs(_value_context):
    """Nodes of the Gauss–Hermite quadrature of a one-dimensional likelihood's expectations."""

    _global_value = 20


class tridiagonal_jitter(_value_context):
    """Floor of the Lanczos-tridiagonal Ritz values before their logarithm."""

    _global_value = 1e-6


class skip_logdet_forward(_feature_flag):
    """Skip the SLQ value of log|K̂| (the gradient still comes from the probe solves).
    The port keeps the forward log-determinant: only the default ``False`` is taken."""

    _default = False


class precond_logdet_vr(_feature_flag):
    """Variance-reduced log-determinant gradient (arXiv 2107.00243): with a preconditioner
    P, d log|K̂| = d log|P| + E_z[(K̂⁻¹z)ᵀ dK̂ (P⁻¹z) − (P⁻¹z)ᵀ dP (P⁻¹z)], z ~ N(0, P)."""

    _default = False


class fast_precond_grad(_feature_flag):
    """Gradient of the pivoted-Cholesky root through the Nyström factor on its fixed
    pivots; its value stays the pivoted-Cholesky factor."""

    _default = True


class cg_lagged_rhs(_feature_flag):
    """rhs-warm training solves: fold the warm start's residual product into CG's first
    iteration (x = 0, r = b, p = x₀ and a forced α = 1, β = 0 on the warm columns)."""

    _default = False


class max_eager_kernel_size(_value_context):
    """Kernel matrices with n·m at most this squared are evaluated densely; larger ones
    stay lazy and every product with them streams through the fused kernel matvec."""

    _global_value = 512


class use_toeplitz(_feature_flag):
    """A grid kernel's per-dimension covariance as a Toeplitz operator (FFT products) rather
    than a dense matrix."""

    _default = True


class memory_efficient(_feature_flag):
    """Never evaluate a kernel matrix densely, whatever its size."""

    _default = False


class detach_test_caches(_feature_flag):
    """On (the default): the prediction caches are built without gradients, so that a
    prediction is differentiable with respect to the test inputs and the test-side
    hyperparameters but not through the caches.  Off: the mean cache (and a fantasy
    model's Schur-updated one) and the exact variance's solve are built with autograd,
    through ``LinearOperator.solve``'s gradient with respect to the operator; such a cache
    serves one prediction, and the next builds its own.  The LOVE branches (``fast_pred_var``,
    ``fast_pred_samples``) raise when it is off."""

    _default = True


class debug(_feature_flag):
    """Extra validation in ``ExactGP.__call__``: a training-mode call on inputs of another
    shape than the training inputs raises, and an eval-mode call on the training inputs
    themselves warns (``GPInputWarning``)."""

    _default = True


class prior_mode(_feature_flag):
    """Models return their prior ``forward`` instead of the posterior."""

    _default = False


class observation_nan_policy(_value_context):
    """What the exact MLL and the mean cache do with NaN targets: "ignore" (use them as
    they are), "mask" (leave those points out, through ``MaskedLinearOperator``) or
    "fill" (replace them by the prior mean)."""

    _global_value = "ignore"


class fast_pred_var(_feature_flag):
    """LOVE predictive variances from the cached Lanczos inverse root."""

    _default = False


class fast_pred_samples(_feature_flag):
    """LOVE posterior sampling: the predictive covariance is returned as the Lanczos root
    of K** − (K*x R)(K*x R)ᵀ, so that each draw is one product with that root."""

    _default = False


class _fast_covar_root_decomposition(_feature_flag):
    _default = True


class _fast_log_prob(_feature_flag):
    _default = True


class _fast_solves(_feature_flag):
    _default = True


class fast_computations:
    """The three iterative-method flags: with one off, its operation takes the dense
    Cholesky branch at any N — root decompositions (``covar_root_decomposition``), log
    densities (``log_prob``), and solves, log densities and root decompositions
    (``solves``)."""

    covar_root_decomposition = _fast_covar_root_decomposition
    log_prob = _fast_log_prob
    solves = _fast_solves

    def __init__(self, covar_root_decomposition: bool = True, log_prob: bool = True, solves: bool = True):
        self._ctxs = [_fast_covar_root_decomposition(covar_root_decomposition), _fast_log_prob(log_prob),
                      _fast_solves(solves)]

    def __enter__(self):
        for ctx in self._ctxs:
            ctx.__enter__()
        return self

    def __exit__(self, *exc):
        for ctx in reversed(self._ctxs):
            ctx.__exit__(*exc)
        return False


class skip_posterior_variances(_feature_flag):
    _default = False


class min_variance(_dtype_value_context):
    """Floor for posterior variances."""

    _global_float_value = 1e-6
    _global_double_value = 1e-10
    _global_half_value = 1e-3


class num_likelihood_samples(_value_context):
    """Monte Carlo draws of a likelihood's expectations, and the sample dimension of a deep
    GP."""

    _global_value = 10


class variational_cholesky_jitter(_dtype_value_context):
    """Jitter added to K_ZZ before a variational strategy factorises it (unless the strategy
    was given its own ``jitter_val``)."""

    _global_float_value = 1e-4
    _global_double_value = 1e-6
    _global_half_value = 1e-3


class min_fixed_noise(_dtype_value_context):
    """Floor of a fixed (user-supplied) observation noise."""

    _global_float_value = 1e-4
    _global_double_value = 1e-6
    _global_half_value = 1e-3


class _linalg_dtype_cholesky(_value_context):
    """Dtype that every dense Cholesky factorisation (``psd_safe_cholesky``) is promoted
    to, the factor cast back to the input's dtype; None factors in the input's dtype."""

    _global_value = torch.float64


class _linalg_dtype_symeig(_value_context):
    """Dtype of the SLQ log-determinant's small symmetric eigenproblems; None keeps the
    operator's dtype."""

    _global_value = torch.float64


class linalg_dtypes:
    """Sets both promotion dtypes for a block: ``default`` for each that is not given
    (float64 if none is)."""

    def __init__(self, default=torch.float64, symeig=None, cholesky=None):
        self._contexts = (_linalg_dtype_cholesky(default if cholesky is None else cholesky),
                          _linalg_dtype_symeig(default if symeig is None else symeig))

    def __enter__(self):
        for ctx in self._contexts:
            ctx.__enter__()
        return self

    def __exit__(self, *exc):
        for ctx in reversed(self._contexts):
            ctx.__exit__(*exc)
        return False
