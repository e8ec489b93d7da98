"""psd_safe_cholesky — Cholesky with an escalating jitter.

Counterpart of ``gpytorch_tpu/solvers/cholesky.py`` at its default settings.  A
floating-point input narrower than ``settings._linalg_dtype_cholesky`` (float64 by default)
is factored in that dtype, with that dtype's base jitter, and the factor cast back, as the
JAX package does under x64.  The base jitter is always added, and raised tenfold per retry
up to ``max_tries``.  The level is chosen on a detached copy, so the one differentiable
factorisation is one that succeeds.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import settings

# base jitter per dtype (the JAX package's ``settings.cholesky_jitter`` defaults)
_JITTER = {torch.float32: 1e-6, torch.float64: 1e-8, torch.float16: 1e-3, torch.bfloat16: 1e-3}


def psd_safe_cholesky(A: torch.Tensor, jitter: Optional[float] = None, max_tries: int = 3) -> torch.Tensor:
    """Lower Cholesky factor of A + jitter·10^i·I for the least i in 0..max_tries that
    factorises (the last one if none does, which then raises)."""
    promote = settings._linalg_dtype_cholesky.value()
    if promote is not None and A.is_floating_point() and torch.finfo(promote).bits > torch.finfo(A.dtype).bits:
        return psd_safe_cholesky(A.to(promote), jitter, max_tries).to(A.dtype)
    if jitter is None:
        jitter = _JITTER[A.dtype]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A_d = A.detach()
    level = 0
    for level in range(int(max_tries) + 1):
        _, info = torch.linalg.cholesky_ex(A_d + (jitter * 10.0**level) * eye)
        if not bool((info != 0).any()):
            break
    return torch.linalg.cholesky(A + (jitter * 10.0**level) * eye)
