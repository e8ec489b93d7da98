"""LinearOperator — lazy matrices whose inference goes through matrix products.

Counterpart of ``gpytorch_tpu/linop/base.py``, ported as far as exact-GP serving, training
and sampling need: ``matmul``; ``solve`` by preconditioned CG (with
``settings.solve_iterative_refinements``); ``inv_quad_logdet`` by mBCG with stochastic
Lanczos quadrature; ``root_decomposition`` and ``root_inv_decomposition`` by block Lanczos;
``zero_mean_mvn_samples`` from the root (or by contour-integral quadrature, as
``sqrt_inv_matmul``); diagonal and row access (for the pivoted-Cholesky
preconditioner), and the structure hooks ``evaluate_kernel``, ``_eig_lower_bound`` and
``_is_known_psd``.  As in the JAX package, each of these takes a dense Cholesky factor
instead up to ``settings.max_cholesky_size``, or at any size when its
``settings.fast_computations`` flag is off (``linop/triangular.py``).

``_flatten`` hands an operator's tensors to a ``torch.autograd.Function`` together with a
function that rebuilds the operator from them (the counterpart of the JAX package's pytree
``tree_map``): a backward rebuilds the operator from copies that require grad and
differentiates through its products.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from .. import settings

# Where the standard-normal base samples of probe vectors come from: a torch.Generator,
# or a callable that returns an array of the shape it is given (injected samples, so that
# two runs or two packages see the same probes), or None for torch's default generator.
ProbeSource = Union[None, torch.Generator, Callable[[Tuple[int, ...]], Any]]


def probe_base_samples(shape, dtype: torch.dtype, device, source: ProbeSource = None) -> torch.Tensor:
    """Standard-normal base samples for probe vectors, of ``shape``, from ``source``.

    Counterpart of ``gpytorch_tpu/linop/base.py::probe_base_samples``; an injected source
    is called with the same shapes as the JAX package draws."""
    shape = tuple(int(s) for s in shape)
    if source is None or isinstance(source, torch.Generator):
        return torch.randn(shape, generator=source, dtype=dtype, device=device)
    out = torch.as_tensor(np.asarray(source(shape)), dtype=dtype, device=device)
    if tuple(out.shape) != shape:
        raise ValueError(f"injected base samples have shape {tuple(out.shape)}, expected {shape}")
    return out


class LinearOperator:
    """Abstract lazy matrix (n, m): subclasses define ``_matmul``, ``_shape``, ``dtype``
    and ``device``, and may override ``_diagonal``, ``to_dense`` and ``_get_rows``."""

    # set by ``solve``: the CGResult of the last CG solve against this operator
    last_cg_result = None

    def _matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _matmul_grad_only(self, rhs: torch.Tensor) -> torch.Tensor:
        """self·rhs for a caller that uses the product only for its gradient (its result
        enters linearly and its value is never read): a lazy kernel operator returns
        zeros with the full backward, and launches no forward product."""
        return self._matmul(rhs)

    def _flatten(self) -> Tuple[Tuple[torch.Tensor, ...], Callable[[Tuple[torch.Tensor, ...]], "LinearOperator"]]:
        """(tensors, rebuild): the tensors the operator is a function of, and a function
        that builds the same operator from other tensors of the same shapes."""
        raise NotImplementedError(f"{type(self).__name__} cannot be flattened")

    def _shape(self):
        raise NotImplementedError

    @property
    def shape(self):
        return tuple(self._shape())

    @property
    def batch_shape(self):
        return self.shape[:-2]

    @property
    def dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def to_dense(self) -> torch.Tensor:
        n = self.shape[-1]
        return self._matmul(torch.eye(n, dtype=self.dtype, device=self.device).expand(self.batch_shape + (n, n)))

    def _diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.to_dense(), dim1=-2, dim2=-1)

    def _get_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Dense rows self[..., idx, :] — what pivoted Cholesky reads: ``idx`` of shape
        (m,), or batch + (m,) for per-element rows of a batched operator."""
        return _take_rows(self.to_dense(), idx)

    def _entries(self, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """self[rows, cols] elementwise for broadcastable index tensors (the q × q blocks
        of an interpolated operator's diagonal); structured operators read them without
        forming the matrix."""
        return self.to_dense()[rows, cols]

    def __getitem__(self, index) -> "LinearOperator":
        """The dense matrix indexed, as a ``DenseLinearOperator``
        (``gpytorch_tpu/linop/base.py:447-448``); operators that can index their own
        structure (a lazy kernel's inputs, an interpolation's rows) override it for the
        indices they take."""
        return DenseLinearOperator(self.to_dense()[index])

    # -- products and arithmetic --------------------------------------------------------
    def matmul(self, rhs: torch.Tensor) -> torch.Tensor:
        if rhs.ndim == 1:
            return self._matmul(rhs.unsqueeze(-1)).squeeze(-1)
        return self._matmul(rhs)

    def __add__(self, other):
        from .composition import SumLinearOperator
        from .diag import DiagLinearOperator
        from .zero import ZeroLinearOperator

        if isinstance(other, ZeroLinearOperator):
            return self
        if isinstance(other, DiagLinearOperator):
            return self.add_diagonal(other._diag_values())
        return SumLinearOperator(self, to_linear_operator(other))

    def __mul__(self, other):
        """An operator times an operator or a tensor of the operator's shape is their
        elementwise (Hadamard) product, ``dense_ops.hadamard_product``; times a scalar (or
        a tensor whose last dimension is 1) a ``ConstantMulLinearOperator``."""
        from .composition import ConstantMulLinearOperator
        from .dense_ops import hadamard_product

        if isinstance(other, LinearOperator):
            return hadamard_product(self, other)
        if torch.is_tensor(other) and other.ndim > 0 and other.shape[-1] != 1:
            return hadamard_product(self, DenseLinearOperator(torch.broadcast_to(other, self.shape)))
        return ConstantMulLinearOperator(self, other)

    def add_diagonal(self, diag: torch.Tensor) -> "LinearOperator":
        """self + diag(d): a ``ConstantDiagLinearOperator`` for a scalar d or one of shape
        batch + (1,), else a ``DiagLinearOperator`` of d broadcast to batch + (n,)."""
        from .added_diag import AddedDiagLinearOperator
        from .diag import ConstantDiagLinearOperator, DiagLinearOperator

        if self.shape[-1] != self.shape[-2]:
            raise RuntimeError("add_diagonal only defined for square operators")
        diag = torch.as_tensor(diag, dtype=self.dtype, device=self.device)
        n = self.shape[-1]
        if diag.numel() == 1:
            diag_op = ConstantDiagLinearOperator(diag.reshape(1), n)
        elif diag.shape[-1] == 1:
            diag_op = ConstantDiagLinearOperator(diag, n)
        else:
            diag_op = DiagLinearOperator(diag.expand(torch.broadcast_shapes(diag.shape, (n,))))
        return AddedDiagLinearOperator(self, diag_op)

    def add_jitter(self, jitter_val: float = 1e-3) -> "LinearOperator":
        return self.add_diagonal(torch.as_tensor(jitter_val, dtype=self.dtype, device=self.device))

    def expand(self, *sizes) -> "LinearOperator":
        """The operator over a larger batch shape (``sizes`` = batch + the matrix shape, or
        the batch alone), as a ``BatchRepeatLinearOperator``: no copy."""
        from .composition import BatchRepeatLinearOperator

        sizes = tuple(int(s) for s in (sizes[0] if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)) else sizes))
        batch = sizes[:-2] if len(sizes) >= 2 else sizes
        if len(sizes) >= 2 and sizes[-2:] != self.shape[-2:]:
            raise RuntimeError("expand cannot change the matrix dimensions")
        return BatchRepeatLinearOperator(self, batch) if batch else self

    # -- structure hooks ----------------------------------------------------------------
    def evaluate_kernel(self) -> "LinearOperator":
        """Hook for LazyEvaluatedKernelOperator; identity elsewhere."""
        return self

    def _preconditioner(self):
        """The preconditioner as (apply_inv, precond_op, logdet_P), or (None, None, None)."""
        return None, None, None

    def _is_known_psd(self) -> bool:
        """True when the operator is positive semi-definite by construction."""
        return False

    def _eig_lower_bound(self) -> Optional[torch.Tensor]:
        """A known lower bound on the eigenvalues (the Lanczos Ritz floor), or None."""
        return None

    def _use_cholesky(self) -> bool:
        return self.shape[-1] <= settings.max_cholesky_size.value() or settings.fast_computations.solves.off()

    def _dense_cholesky(self) -> torch.Tensor:
        """Lower Cholesky factor of the dense matrix with escalating jitter
        (``psd_safe_cholesky``), of its symmetrised part, as ``jnp.linalg.cholesky`` takes
        it (torch's reads one triangle): a covariance formed by subtraction is symmetric
        only to round-off."""
        from ..solvers.cholesky import psd_safe_cholesky

        A = self.to_dense()
        return psd_safe_cholesky(0.5 * (A + A.mT))

    # -- decompositions and solves ------------------------------------------------------
    def cholesky(self, upper: bool = False) -> "LinearOperator":
        from .triangular import TriangularLinearOperator

        L = self._dense_cholesky()
        return TriangularLinearOperator(L.mT, upper=True) if upper else TriangularLinearOperator(L)

    def _root_method(self, method: Optional[str]) -> str:
        if method is not None:
            return method
        dense = self._use_cholesky() or settings.fast_computations.covar_root_decomposition.off()
        return "cholesky" if dense else "lanczos"

    def root_decomposition(self, method: Optional[str] = None) -> "LinearOperator":
        """R Rᵀ ≈ self: the Cholesky factor, or a Lanczos root of rank
        ``max_root_decomposition_size`` (``method`` "cholesky" or "lanczos"; by default
        as ``root_inv_decomposition`` chooses).  The Lanczos start block is drawn from a
        CPU generator seeded with 0."""
        from ..solvers.lanczos import lanczos_root
        from .root import RootLinearOperator
        from .triangular import CholLinearOperator

        if self._root_method(method) == "cholesky":
            return CholLinearOperator(self._dense_cholesky()).root_decomposition()
        max_rank = min(self.shape[-1], settings.max_root_decomposition_size.value())
        return RootLinearOperator(lanczos_root(self, max_rank))

    def root_inv_decomposition(self, initial_vectors: Optional[torch.Tensor] = None,
                               method: Optional[str] = None) -> "LinearOperator":
        """R Rᵀ ≈ self⁻¹ (the LOVE cache): R = L⁻ᵀ from the Cholesky factor L up to
        ``max_cholesky_size``, else by block Lanczos, whose start block is
        ``initial_vectors`` where given, the rest drawn from a CPU generator seeded with 0
        and moved to the operator's device."""
        from ..solvers.lanczos import lanczos_inv_root
        from .root import RootLinearOperator
        from .triangular import CholLinearOperator

        if self._root_method(method) == "cholesky":
            return CholLinearOperator(self._dense_cholesky()).root_inv_decomposition()
        max_rank = min(self.shape[-1], settings.max_root_decomposition_size.value())
        return RootLinearOperator(lanczos_inv_root(self, max_rank, initial_vectors))

    def zero_mean_mvn_samples(self, num_samples: int, base_samples: ProbeSource = None) -> torch.Tensor:
        """(num_samples, n) draws of N(0, self) from its root decomposition, or under
        ``settings.ciq_samples`` as K^{1/2}ε by contour-integral quadrature; the base
        samples ε come from ``base_samples`` (``probe_base_samples``), always Gaussian."""
        if settings.ciq_samples.on():
            from ..solvers.contour import contour_integral_quad

            eps = probe_base_samples(self.batch_shape + (self.shape[-1], num_samples), self.dtype, self.device,
                                     base_samples)
            return contour_integral_quad(self, eps, inverse=False).movedim(-1, 0)
        return self.root_decomposition().zero_mean_mvn_samples(num_samples, base_samples)

    def sqrt_inv_matmul(self, rhs: torch.Tensor, lhs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """self^{-1/2} rhs (lhs self^{-1/2} rhs where ``lhs`` is given) by contour-integral
        quadrature (``solvers/contour.py``)."""
        from ..solvers.contour import sqrt_inv_matmul

        return sqrt_inv_matmul(self, rhs, lhs)

    def inv_quad_logdet(self, inv_quad_rhs: Optional[torch.Tensor] = None, logdet: bool = False,
                        reduce_inv_quad: bool = True, base_samples: ProbeSource = None,
                        solver_state: Optional[torch.Tensor] = None, return_state: bool = False):
        """(rhsᵀ self⁻¹ rhs, log|self|), differentiable.  Up to ``max_cholesky_size`` (or
        with ``fast_computations.log_prob`` off) from the dense Cholesky factor L:
        log|self| = 2 Σ log diag L and rhsᵀ self⁻¹ rhs = |L⁻¹ rhs|², as the JAX package
        computes it (``gpytorch_tpu/linop/base.py::inv_quad_logdet``); the solver state
        passes through untouched.  Above it, in one mBCG pass with the BBMM backward
        (``solvers/inv_quad.py``): ``base_samples`` is where the probe vectors' base samples
        come from, and ``solver_state``/``return_state`` carry the warm start of the rhs
        solve across training steps."""
        if self._use_cholesky() or settings.fast_computations.log_prob.off():
            L = self._dense_cholesky()
            logdet_term = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1) if logdet else None
            iq_term = None
            if inv_quad_rhs is not None:
                rhs = inv_quad_rhs if inv_quad_rhs.ndim > 1 else inv_quad_rhs.unsqueeze(-1)
                iq_term = torch.linalg.solve_triangular(L, rhs, upper=False).square().sum(-2)
                if reduce_inv_quad:
                    iq_term = iq_term.sum(-1)
            return ((iq_term, logdet_term), solver_state) if return_state else (iq_term, logdet_term)
        from ..solvers.inv_quad import inv_quad_logdet_mbcg

        return inv_quad_logdet_mbcg(
            self.evaluate_kernel(), inv_quad_rhs, logdet=logdet, reduce_inv_quad=reduce_inv_quad,
            base_samples=base_samples, solver_state=solver_state, return_state=return_state,
        )

    def logdet(self) -> torch.Tensor:
        """log|self|, by ``inv_quad_logdet``."""
        return self.inv_quad_logdet(logdet=True)[1]

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """self⁻¹ rhs: by ``torch.cholesky_solve`` on the dense Cholesky factor up to
        ``max_cholesky_size`` (differentiable in both), else by preconditioned CG with
        ``settings.solve_iterative_refinements`` passes of refinement, its CGResult kept in
        ``last_cg_result``.

        CG is differentiable with respect to ``rhs`` and to the operator's tensors
        (``_Solve``)."""
        from ..solvers.cg import linear_solve_cg
        from .triangular import CholLinearOperator

        if self._use_cholesky():
            return CholLinearOperator(self._dense_cholesky()).solve(rhs)
        squeeze = rhs.ndim == 1
        if squeeze:
            rhs = rhs.unsqueeze(-1)
        op = self.evaluate_kernel()
        tensors, rebuild = (), None
        if torch.is_grad_enabled():
            try:
                tensors, rebuild = op._flatten()
            except NotImplementedError:
                if rhs.requires_grad:  # an operator without _flatten is solved without gradients
                    raise
        if rebuild is not None and (rhs.requires_grad or any(t.requires_grad for t in tensors)):
            solution = _Solve.apply(self, rebuild, rhs, *tensors)
        else:
            self.last_cg_result = linear_solve_cg(op, rhs)
            solution = self.last_cg_result.solution
        return solution.squeeze(-1) if squeeze else solution


class ClosedFormInvQuadLogdet:
    """``inv_quad_logdet`` for an operator whose quadratic form and log-determinant have
    closed forms at every size, whatever ``max_cholesky_size`` says: the operator gives
    ``_inv_quad_cols(rhs)`` (rhsᵀ self⁻¹ rhs for each column of rhs (..., n, k)) and
    ``logdet()``.  The solver state passes through untouched."""

    def inv_quad_logdet(self, inv_quad_rhs=None, logdet=False, reduce_inv_quad=True, base_samples=None,
                        solver_state=None, return_state=False):
        iq = None
        if inv_quad_rhs is not None:
            iq = self._inv_quad_cols(inv_quad_rhs if inv_quad_rhs.ndim > 1 else inv_quad_rhs.unsqueeze(-1))
            if reduce_inv_quad:
                iq = iq.sum(-1)
        res = (iq, self.logdet() if logdet else None)
        return (res, solver_state) if return_state else res


class _Solve(torch.autograd.Function):
    """op⁻¹ rhs, differentiable in rhs and in the operator's tensors (``_flatten``): the
    JAX package's custom VJP (``gpytorch_tpu/solvers/cg.py::_linear_solve_cg``).  The
    backward solves u = op⁻¹ g (op is symmetric) by the same refined CG as the forward, so
    rhs̄ = u, and takes the operator's cotangents as those of −Σ u ⊙ (op · sol), a product
    whose value is never read (``_matmul_grad_only``: for a lazy kernel operator the fused
    backward kernel at t = sol's columns, and no forward product).  The tolerance, the
    iteration limit, the stall window, the refinement passes and the preconditioner are
    the forward's: a backward runs after the caller's settings have gone out of scope."""

    @staticmethod
    def forward(ctx, owner, rebuild, rhs, *tensors):
        from ..solvers.cg import linear_cg, refined_solve

        op = rebuild(tensors)
        cg = functools.partial(linear_cg, op._matmul, precond_fn=op._preconditioner()[0],
                               max_iter=settings.max_cg_iterations.value(), tolerance=settings.cg_tolerance.value())
        stall, passes = settings.cg_stall_window.value(), settings.solve_iterative_refinements.value()

        def solve(b):
            with settings.cg_stall_window(stall), settings.solve_iterative_refinements(passes):
                return refined_solve(cg, op._matmul, b)

        owner.last_cg_result = solve(rhs)
        sol = owner.last_cg_result.solution
        ctx.solve, ctx.rebuild = solve, rebuild
        ctx.save_for_backward(sol, *tensors)
        return sol

    @staticmethod
    def backward(ctx, g):
        sol, *tensors = ctx.saved_tensors
        u = ctx.solve(g.contiguous()).solution
        needs = ctx.needs_input_grad[3:]
        grads = iter(())
        if any(needs):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(need) for t, need in zip(tensors, needs)]
                quad = -(u * ctx.rebuild(leaves)._matmul_grad_only(sol)).sum()
                grads = iter(torch.autograd.grad(quad, [leaf for leaf in leaves if leaf.requires_grad],
                                                 allow_unused=True))
        return (None, None, u if ctx.needs_input_grad[2] else None,
                *[next(grads) if need else None for need in needs])


class DenseLinearOperator(LinearOperator):
    """A dense (n, m) tensor as an operator."""

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor

    def _shape(self):
        return self.tensor.shape

    @property
    def dtype(self):
        return self.tensor.dtype

    @property
    def device(self):
        return self.tensor.device

    def _matmul(self, rhs):
        return self.tensor @ rhs

    def to_dense(self):
        return self.tensor

    def _get_rows(self, idx):
        return _take_rows(self.tensor, idx)

    def _entries(self, rows, cols):
        return self.tensor[rows, cols]

    def _flatten(self):
        return (self.tensor,), lambda ts: DenseLinearOperator(ts[0])

    def __getitem__(self, index):
        return DenseLinearOperator(self.tensor[index])


def to_linear_operator(obj) -> LinearOperator:
    return obj if isinstance(obj, LinearOperator) else DenseLinearOperator(obj)


def two_slices(index) -> bool:
    """Whether ``index`` is ``[rows, cols]`` or ``[..., rows, cols]`` with two slices: the
    index that a structured operator takes on its own structure."""
    return isinstance(index, tuple) and (len(index) == 2 or (len(index) == 3 and index[0] is Ellipsis)) and \
        isinstance(index[-2], slice) and isinstance(index[-1], slice)


def _take_rows(dense: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """dense[..., idx, :]: idx of shape batch + (m,) (or (m,), shared) picks rows of each
    element."""
    batch = dense.shape[:-2]
    idx = idx.expand(batch + idx.shape[-1:])
    return torch.take_along_dim(dense, idx.unsqueeze(-1), dim=-2)
