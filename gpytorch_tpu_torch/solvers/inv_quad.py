"""mBCG inv_quad_logdet with the BBMM backward — the primitive of the training objective.

Counterpart of ``gpytorch_tpu/solvers/inv_quad.py`` (paper: arXiv 1809.11165), in its
cold mode and its rhs-only warm mode.

Forward:
  * probe vectors z_j ~ N(0, P) from the pivoted-Cholesky preconditioner P (or N(0, I)),
    normalised;
  * one preconditioned CG solve of K̂⁻¹[rhs, ẑ₁..ẑ_t] (mBCG), with the Lanczos tridiagonals
    T_j of the probe columns from the CG coefficients;
  * rhsᵀK̂⁻¹rhs from the rhs column, log|K̂| ≈ log|P| + n·mean_j e₁ᵀ log(T_j) e₁ (SLQ).

Backward (a ``torch.autograd.Function``; the operator comes in flattened, see
``LinearOperator._flatten``, and is rebuilt from copies that require grad):
  * d(rhsᵀK̂⁻¹rhs) = −(K̂⁻¹rhs)ᵀ dK̂ (K̂⁻¹rhs), with K̂⁻¹rhs from the forward;
  * d log|K̂| ≈ mean_j ‖z_j‖² (K̂⁻¹ẑ_j)ᵀ dK̂ (P⁻¹ẑ_j), or with ``precond_logdet_vr`` the
    variance-reduced d log|P| + mean_j ‖z_j‖² [(K̂⁻¹ẑ_j)ᵀ dK̂ (P⁻¹ẑ_j) − (P⁻¹ẑ_j)ᵀ dP (P⁻¹ẑ_j)]
    with P rebuilt differentiably;
  both as the gradient of one product of K̂ with [K̂⁻¹rhs, P⁻¹ẑ] whose value is never read
  (``_matmul_grad_only``: the fused backward kernel, and no forward product).  The rhs
  cotangent is 2·(K̂⁻¹rhs)·g.

The settings the backward needs are snapshotted when the objective is called
(``_IQConfig``): a backward runs after the caller's ``with`` block has exited.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from .. import settings
from .cg import linear_cg, tridiag_from_coeffs


class MBCGState(NamedTuple):
    """What a training solve hands to the next one: the rhs solves (*batch, n, t_rhs),
    detached, and the CG iterations the solve ran."""

    solution: torch.Tensor
    num_iters: int


@dataclasses.dataclass(frozen=True)
class _IQConfig:
    has_rhs: bool
    logdet: bool
    reduce_inv_quad: bool
    num_probes: int
    n_tridiag_iter: int
    max_iter: int
    tolerance: float
    tridiagonal_jitter: float
    precond_logdet_vr: bool
    lagged_rhs: bool
    pc_rank: int
    pc_min_size: int
    pc_noise_budget: float
    pc_tolerance: float
    fast_pc_grad: bool
    warm_rhs: bool = False

    @classmethod
    def snapshot(cls, has_rhs: bool, logdet: bool, reduce_inv_quad: bool) -> "_IQConfig":
        return cls(
            has_rhs=has_rhs,
            logdet=logdet,
            reduce_inv_quad=reduce_inv_quad,
            num_probes=int(settings.num_trace_samples.value()),
            n_tridiag_iter=int(settings.max_lanczos_quadrature_iterations.value()),
            max_iter=int(settings.max_cg_iterations.value()),
            tolerance=float(settings.cg_tolerance.value()),
            tridiagonal_jitter=float(settings.tridiagonal_jitter.value()),
            precond_logdet_vr=settings.precond_logdet_vr.on(),
            lagged_rhs=settings.cg_lagged_rhs.on(),
            pc_rank=int(settings.max_preconditioner_size.value()),
            pc_min_size=int(settings.min_preconditioning_size.value()),
            pc_noise_budget=float(settings.preconditioner_noise_budget.value()),
            pc_tolerance=float(settings.preconditioner_tolerance.value()),
            fast_pc_grad=settings.fast_precond_grad.on(),
        )

    def preconditioner_settings(self) -> contextlib.ExitStack:
        """The preconditioner's settings as they were at the call."""
        stack = contextlib.ExitStack()
        for ctx in (
            settings.max_preconditioner_size(self.pc_rank),
            settings.min_preconditioning_size(self.pc_min_size),
            settings.preconditioner_noise_budget(self.pc_noise_budget),
            settings.preconditioner_tolerance(self.pc_tolerance),
            settings.fast_precond_grad(self.fast_pc_grad),
        ):
            stack.enter_context(ctx)
        return stack


def inv_quad_logdet_mbcg(linop, inv_quad_rhs: Optional[torch.Tensor] = None, logdet: bool = False,
                         reduce_inv_quad: bool = True, base_samples=None,
                         solver_state: Union[None, torch.Tensor, MBCGState] = None, return_state: bool = False):
    """(rhsᵀ linop⁻¹ rhs, log|linop|) by one mBCG solve, differentiable w.r.t. the
    operator's tensors and the rhs; an entry is None where not asked for.  A batched
    operator gives one value of each per batch element (shape batch), from probes of
    shape batch + (n, probes) in one CG loop (``gpytorch_tpu/solvers/inv_quad.py:223-261,
    299-396``).

    ``base_samples``: where the probes' standard-normal base samples come from (a
    ``torch.Generator``, a callable that returns them for a shape, or None); see
    ``linop.base.probe_base_samples``.

    ``solver_state``/``return_state``: the rhs-only warm mode of the JAX package.  Pass the
    state the previous step returned (or a tensor (n, t_rhs) to start from, zeros for a
    cold first step) and ``return_state=True`` to get ``((iq, ld), MBCGState)`` back.
    The rhs columns start from the state and alone gate CG's stop; the probes are fresh,
    start at zero and run at least ``max_lanczos_quadrature_iterations`` iterations.
    The full-width warm mode (all columns warm) and ``skip_logdet_forward`` are not
    ported."""
    if settings.skip_logdet_forward.on():
        raise NotImplementedError("skip_logdet_forward is not ported: the forward log-determinant is always computed")
    has_rhs = inv_quad_rhs is not None
    cfg = _IQConfig.snapshot(has_rhs, bool(logdet), bool(reduce_inv_quad))
    n = linop.shape[-1]
    if has_rhs:
        rhs = inv_quad_rhs if inv_quad_rhs.ndim > 1 else inv_quad_rhs.unsqueeze(-1)
    else:
        rhs = torch.zeros(linop.batch_shape + (n, 1), dtype=linop.dtype, device=linop.device)
    x0 = None
    if solver_state is not None:
        x0 = solver_state.solution if isinstance(solver_state, MBCGState) else solver_state
        if not (cfg.logdet and has_rhs and x0.shape == rhs.shape):
            raise NotImplementedError(
                f"only the rhs-only warm state is ported: a state of shape {tuple(rhs.shape)} with logdet=True "
                f"and an rhs, got {tuple(x0.shape)}"
            )
        cfg = dataclasses.replace(cfg, warm_rhs=True)
        x0 = x0.detach()
    tensors, rebuild = linop._flatten()
    stats = {}
    iq, ld, solves = _MBCG.apply(cfg, rebuild, base_samples, stats, rhs, x0, *tensors)
    if has_rhs and inv_quad_rhs.ndim == 1 and not cfg.reduce_inv_quad:
        iq = iq[..., 0]
    out = (iq if has_rhs else None), (ld if logdet else None)
    if return_state:
        return out, MBCGState(solves, stats["num_iters"])
    return out


class _MBCG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, rebuild, base_samples, stats, rhs, x0, *tensors):
        from ..linop.base import probe_base_samples

        linop = rebuild(tensors)
        n, dt, dev, batch = linop.shape[-1], rhs.dtype, rhs.device, linop.batch_shape
        t_rhs = rhs.shape[-1] if cfg.has_rhs else 0
        apply_P, P_op, logdet_P = linop._preconditioner()

        probes = norms = None
        rhs_all = rhs
        if cfg.logdet:
            if P_op is not None:
                z = P_op.zero_mean_mvn_samples(cfg.num_probes, base_samples).movedim(0, -1)  # (*batch, n, t)
            else:
                z = probe_base_samples(batch + (n, cfg.num_probes), dt, dev, base_samples)
            norms = torch.sqrt(torch.clamp_min((z * z).sum(-2), 1e-20)).unsqueeze(-2)  # (*batch, 1, t)
            probes = z / norms
            rhs_all = torch.cat([rhs, probes], -1) if cfg.has_rhs else probes

        x0_cg, conv_cols = None, None
        if cfg.warm_rhs:
            # warm rhs columns, fresh zero-start probe columns; only the rhs gates the stop
            x0_cg = torch.cat([x0, torch.zeros_like(probes)], -1)
            conv_cols = t_rhs
        result = linear_cg(
            linop._matmul, rhs_all, precond_fn=apply_P, max_iter=cfg.max_iter, tolerance=cfg.tolerance,
            n_tridiag_iter=cfg.n_tridiag_iter if cfg.logdet else 0, x0=x0_cg, conv_cols=conv_cols,
            lagged_rhs_init=cfg.warm_rhs and cfg.lagged_rhs,
        )
        stats["num_iters"] = result.num_iters
        solves = result.solution

        iq = torch.zeros(batch, dtype=dt, device=dev)
        s_rhs = solves[..., :t_rhs]
        if cfg.has_rhs:
            iq = (rhs * s_rhs).sum(-2)
            if cfg.reduce_inv_quad:
                iq = iq.sum(-1)

        ld = torch.zeros(batch, dtype=dt, device=dev)
        s_probe = pinv_probes = None
        if cfg.logdet:
            s_probe = solves[..., t_rhs:]
            pinv_probes = apply_P(probes) if apply_P is not None else probes
            T = tridiag_from_coeffs(result.alphas[..., t_rhs:], result.betas[..., t_rhs:])  # (*batch, t, m, m)
            # the small eigenproblems in settings._linalg_dtype_symeig where it is wider
            sym = settings._linalg_dtype_symeig.value()
            lam, V = torch.linalg.eigh(T.to(sym) if sym is not None and torch.finfo(sym).bits > torch.finfo(dt).bits else T)
            lam = torch.clamp_min(lam, cfg.tridiagonal_jitter)
            slq = (V[..., 0, :] ** 2 * torch.log(lam)).sum(-1).to(dt)  # (*batch, t)
            ld = n * slq.mean(-1)
            if logdet_P is not None:
                ld = ld + logdet_P.to(dt)

        state = s_rhs if cfg.warm_rhs else solves
        ctx.cfg, ctx.rebuild, ctx.had_precond = cfg, rebuild, apply_P is not None
        ctx.save_for_backward(s_rhs, s_probe, pinv_probes, norms, *tensors)
        ctx.mark_non_differentiable(state)
        return iq, ld, state

    @staticmethod
    def backward(ctx, g_iq, g_ld, _g_state):
        cfg = ctx.cfg
        s_rhs, s_probe, pinv_probes, norms, *tensors = ctx.saved_tensors
        needs = ctx.needs_input_grad[6:]
        t_rhs = s_rhs.shape[-1] if cfg.has_rhs else 0
        grads = ()
        if any(needs):
            with torch.enable_grad(), cfg.preconditioner_settings():
                leaves = [t.detach().requires_grad_(need) for t, need in zip(tensors, needs)]
                lo = ctx.rebuild(leaves)
                cols = ([s_rhs] if cfg.has_rhs else []) + ([pinv_probes] if cfg.logdet else [])
                K_all = lo._matmul_grad_only(torch.cat(cols, -1))
                total = torch.zeros((), dtype=K_all.dtype, device=K_all.device)
                if cfg.has_rhs:
                    quad = (s_rhs * K_all[..., :t_rhs]).sum(-2)
                    if cfg.reduce_inv_quad:
                        quad = quad.sum(-1)
                    total = total - (g_iq * quad).sum()
                if cfg.logdet:
                    est = (s_probe * K_all[..., t_rhs:]).sum(-2)  # (*batch, t)
                    if cfg.precond_logdet_vr and ctx.had_precond:
                        _, P_op, logdet_P = lo._preconditioner()
                        est = est - (pinv_probes * P_op._matmul(pinv_probes)).sum(-2)
                        est = (norms[..., 0, :] ** 2 * est).mean(-1) + logdet_P
                    else:
                        est = (norms[..., 0, :] ** 2 * est).mean(-1)
                    total = total + (g_ld * est).sum()
                wrt = [leaf for leaf in leaves if leaf.requires_grad]
                grads = iter(torch.autograd.grad(total, wrt, allow_unused=True))
        op_grads = [next(grads) if need else None for need in needs]

        rhs_bar = None
        if cfg.has_rhs and ctx.needs_input_grad[4]:
            g = g_iq.reshape(g_iq.shape + (1, 1)) if cfg.reduce_inv_quad else g_iq.unsqueeze(-2)
            rhs_bar = 2.0 * s_rhs * g
        return (None, None, None, None, rhs_bar, None, *op_grads)
