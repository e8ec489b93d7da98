"""Block-Krylov Rayleigh–Ritz root decompositions (the LOVE caches and sampling root), and
the single-vector Lanczos tridiagonalisation that estimates CIQ's spectrum.

Counterpart of ``gpytorch_tpu/solvers/lanczos.py`` (``lanczos_tridiag``,
``block_lanczos_ritz``, ``_ritz_root``, ``lanczos_root`` and ``lanczos_inv_root``).  The start block
is explicit: ``initial_vectors`` where given, the rest drawn from a seeded
``torch.Generator`` on the CPU and then moved to the operator's device, so that a CPU run
and a CUDA run start from the same block.

With autograd on, a root carries the history of the operator's products through the QR
factorisations, the re-orthogonalisation and the eigendecomposition, as the JAX package
differentiates its run; the start block and the Ritz floor carry none.  The eigh backward
divides by the gaps λᵢ − λⱼ of the Ritz values: a degenerate spectrum has no finite
gradient in either package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# lowest Ritz value kept in the inverse root, before the operator's own lower bound
_EIG_FLOOR = 1e-8


def lanczos_tridiag(matmul_fn, init_vec: torch.Tensor, num_iter: int, eps: float = 1e-10):
    """``num_iter`` single-vector Lanczos steps from ``init_vec`` (*batch, n), each
    re-orthogonalised twice against every earlier vector: (Q (*batch, n, k) orthonormal,
    T (*batch, k, k) tridiagonal) with Qᵀ A Q ≈ T (``gpytorch_tpu/solvers/lanczos.py:17``).
    One product with a single column a step."""
    q = init_vec / init_vec.norm(dim=-1, keepdim=True).clamp_min(eps)
    k = int(min(num_iter, q.shape[-1]))
    Q = q.unsqueeze(-2)  # (*batch, j + 1, n): the vectors so far, as rows
    q_prev, beta_prev = torch.zeros_like(q), torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    alphas, betas = [], []
    for j in range(k):
        v = matmul_fn(q.unsqueeze(-1)).squeeze(-1)
        alpha = (q * v).sum(-1)
        v = v - alpha.unsqueeze(-1) * q - beta_prev.unsqueeze(-1) * q_prev
        for _ in range(2):
            v = v - ((Q @ v.unsqueeze(-1)).mT @ Q).squeeze(-2)
        beta = v.norm(dim=-1)
        q_prev, q, beta_prev = q, v / beta.clamp_min(eps).unsqueeze(-1), beta
        alphas.append(alpha)
        betas.append(beta)
        if j + 1 < k:
            Q = torch.cat([Q, q.unsqueeze(-2)], dim=-2)
    T = torch.diag_embed(torch.stack(alphas, -1))
    if k > 1:
        off = torch.stack(betas[:-1], -1)
        T = T + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)
    return Q.mT, T


def block_lanczos_ritz(matmul_fn, init_block: torch.Tensor, num_blocks: int):
    """Q (*batch, n, m·b) orthonormal, spanning span{Ω, AΩ, …, A^{m-1}Ω}, and T = Qᵀ A Q,
    for a start block Ω of shape (*batch, n, b) (``gpytorch_tpu/solvers/lanczos.py:136-141``)."""
    n, b = init_block.shape[-2:]
    # more columns than n would make the trailing qr emit directions not orthogonal to
    # earlier blocks — cap the basis at n columns by narrowing the final block
    Q, _ = torch.linalg.qr(init_block[..., : min(b, n)])
    Qs, AQs = [Q], []
    cols = Q.shape[-1]
    for j in range(num_blocks):
        V = matmul_fn(Q)
        AQs.append(V)
        if j < num_blocks - 1 and cols < n:
            # full re-orthogonalisation, twice, against every previous block
            width = min(b, n - cols)
            V = V[..., :width]
            for _ in range(2):
                for Qi in Qs:
                    V = V - Qi @ (Qi.mT @ V)
            Q, _ = torch.linalg.qr(V)
            Qs.append(Q)
            cols += width
        elif j < num_blocks - 1:
            break
    Qf = torch.cat(Qs, dim=-1)
    T = Qf.mT @ torch.cat(AQs, dim=-1)
    return Qf, 0.5 * (T + T.mT)


def _block_init(linop, initial_vectors: Optional[torch.Tensor], block_size: int) -> torch.Tensor:
    """The start block, of shape batch + (n, block_size)."""
    batch, n = linop.batch_shape, linop.shape[-1]
    # drawn in float64 on the CPU from a generator seeded with 0, whatever the operator's
    # dtype and device, so every precision and device starts from the same block
    generator = torch.Generator().manual_seed(0)
    omega = torch.randn(batch + (n, block_size), generator=generator, dtype=torch.float64).to(linop.device, linop.dtype)
    if initial_vectors is not None:
        vecs = initial_vectors if initial_vectors.ndim >= len(batch) + 2 else initial_vectors.unsqueeze(-1)
        k = min(block_size, vecs.shape[-1])
        vecs = vecs[..., :k].to(dtype=linop.dtype, device=linop.device).expand(batch + (n, k))
        omega = torch.cat([vecs, omega[..., k:]], dim=-1)
    return omega


def _block_plan(max_rank: int, n: int) -> Tuple[int, int]:
    """(block_size, num_blocks): Krylov degree ≥ 5, block width ≤ 32."""
    b = max(1, min(32, -(-max_rank // 5), n))
    return b, -(-max_rank // b)


def _ritz_root(linop, max_rank: int, initial_vectors: Optional[torch.Tensor], inverse: bool) -> torch.Tensor:
    """R = Q V Λ^{∓1/2} from the top ``max_rank`` Ritz pairs (Λ, V) of T = Qᵀ A Q."""
    n = linop.shape[-1]
    b, m = _block_plan(max_rank, n)
    Q, T = block_lanczos_ritz(linop._matmul, _block_init(linop, initial_vectors, b), m)
    lam, V = torch.linalg.eigh(T)
    lam = lam[..., -max_rank:].clamp_min(_EIG_FLOOR)
    # Floor the Ritz values at the operator's spectral lower bound (σ² for K + σ²I): in
    # float32 the smallest Ritz values of a large K̂ are rounding noise, and in the
    # inverse root they become 1/√λ spikes that turn LOVE variances negative.  Cauchy
    # interlacing makes the clamp exact in exact arithmetic.
    # The floor is a constant of the gradient (``stop_gradient`` in the JAX package): a
    # clamped Ritz value sends nothing to the noise.
    bound = linop._eig_lower_bound()
    if bound is not None:
        bound = torch.as_tensor(bound, dtype=lam.dtype, device=lam.device).detach()
        lam = torch.maximum(lam, bound.unsqueeze(-1) if bound.ndim else bound)  # per batch element
    V = V[..., -max_rank:]
    scale = torch.sqrt(lam).unsqueeze(-2)
    return Q @ (V / scale if inverse else V * scale)


def lanczos_root(linop, max_rank: int, initial_vectors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """R with R Rᵀ ≈ linop, of rank ``max_rank``."""
    return _ritz_root(linop, max_rank, initial_vectors, inverse=False)


def lanczos_inv_root(linop, max_rank: int, initial_vectors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """R with R Rᵀ ≈ linop⁻¹, of rank ``max_rank``."""
    return _ritz_root(linop, max_rank, initial_vectors, inverse=True)
