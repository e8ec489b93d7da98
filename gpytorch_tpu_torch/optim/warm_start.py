"""The rhs-only warm start of mBCG training.  Counterpart of
``gpytorch_tpu/optim/warm_start.py::rhs_warm_context``; the windowed full-width recipe
(``WarmStartSchedule``) is not ported.

The state a training step hands to the next carries only the rhs solve (n, num_rhs); the
probe vectors are drawn fresh each step and start at zero, so the SLQ tridiagonals stay
valid, and only the rhs columns gate CG's stop.  The probe solves are then cut at the
``max_lanczos_quadrature_iterations`` floor, which under ``precond_logdet_vr`` perturbs
only the small variance-reduced residual of the log-determinant gradient.  The JAX
package measured two requirements at N=100k: a floor of 10 (at 5 the noise collapsed) and
a decaying learning rate.
"""

from __future__ import annotations

import contextlib

from .. import settings


def rhs_warm_context(probe_iters: int = 10) -> contextlib.ExitStack:
    """Settings for the rhs-only warm recipe: ``precond_logdet_vr`` on, and
    ``max_lanczos_quadrature_iterations`` (the per-step CG floor, the probe-solve budget)
    set to ``probe_iters``.  Use with a state of shape (n, num_rhs) and fresh probes each
    step::

        state = torch.zeros(n, 1)
        with rhs_warm_context():
            value, state = mll(model(x), y, base_samples=generator, solver_state=state,
                               return_state=True)
    """
    stack = contextlib.ExitStack()
    stack.enter_context(settings.precond_logdet_vr(True))
    stack.enter_context(settings.max_lanczos_quadrature_iterations(int(probe_iters)))
    return stack
