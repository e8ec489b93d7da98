"""Block-structured operators: the covariance of independent tasks, one block per task.

Counterpart of ``gpytorch_tpu/linop/block.py``.  ``BlockDiagLinearOperator`` reads the last
batch dimension of a base operator (..., B, n, n) as the diagonal blocks of a
(..., B·n, B·n) operator in the block layout (index b·n + i is block b, row i);
``BlockInterleavedLinearOperator`` is the same matrix in the interleaved layout (index
i·B + b), the default layout of ``MultitaskMultivariateNormal``.  Products, solves, log-determinants, Cholesky
factors and roots go to the blocks as a batch.
"""

from __future__ import annotations

import torch

from .base import DenseLinearOperator, LinearOperator, ProbeSource, to_linear_operator


class BlockDiagLinearOperator(LinearOperator):
    def __init__(self, base: LinearOperator):
        self.base = to_linear_operator(base)
        if len(self.base.shape) < 3:
            raise ValueError("BlockDiagLinearOperator requires a batched base operator")

    @property
    def num_blocks(self) -> int:
        return self.base.shape[-3]

    def _shape(self):
        s = self.base.shape
        return tuple(s[:-3]) + (s[-3] * s[-2], s[-3] * s[-1])

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def _blockify(self, rhs: torch.Tensor) -> torch.Tensor:
        """(..., B·n, k) → (..., B, n, k)."""
        return rhs.reshape(rhs.shape[:-2] + (self.num_blocks, self.base.shape[-1], rhs.shape[-1]))

    def _unblockify(self, x: torch.Tensor) -> torch.Tensor:
        """(..., B, m, k) → (..., B·m, k)."""
        return x.reshape(x.shape[:-3] + (x.shape[-3] * x.shape[-2], x.shape[-1]))

    def _matmul(self, rhs):
        return self._unblockify(self.base._matmul(self._blockify(rhs)))

    def _flatten(self):
        tb, rb = self.base._flatten()
        cls = type(self)
        return tb, lambda ts: cls(rb(ts))

    def _diagonal(self):
        d = self.base._diagonal()  # (..., B, n)
        return d.reshape(d.shape[:-2] + (d.shape[-2] * d.shape[-1],))

    def to_dense(self):
        # dense[b·n + i, c·m + j] = δ_bc K_b[i, j]
        Kb = self.base.to_dense()
        B, n, m = Kb.shape[-3:]
        eye = torch.eye(B, dtype=Kb.dtype, device=Kb.device)
        big = (Kb.unsqueeze(-3) * eye[:, :, None, None]).transpose(-3, -2)  # (..., B, n, B, m)
        return big.reshape(Kb.shape[:-3] + (B * n, B * m))

    def solve(self, rhs):
        squeeze = rhs.ndim == 1
        rhs = rhs.unsqueeze(-1) if squeeze else rhs
        res = self._unblockify(self.base.solve(self._blockify(rhs)))
        return res.squeeze(-1) if squeeze else res

    def inv_quad_logdet(self, inv_quad_rhs=None, logdet=False, reduce_inv_quad=True, base_samples: ProbeSource = None,
                        solver_state=None, return_state=False):
        """From the blocks' (rhs_bᵀ K_b⁻¹ rhs_b, log|K_b|), summed over the blocks."""
        rhs_b = None
        if inv_quad_rhs is not None:
            rhs = inv_quad_rhs if inv_quad_rhs.ndim > 1 else inv_quad_rhs.unsqueeze(-1)
            rhs_b = self._blockify(rhs)
        iq_b, ld_b = self.base.inv_quad_logdet(rhs_b, logdet=logdet, reduce_inv_quad=reduce_inv_quad,
                                               base_samples=base_samples)
        # the blocks are the last batch dimension: of the inv_quad's (..., B) when reduced,
        # of its (..., B, k) when not
        iq = None if iq_b is None else iq_b.sum(-1 if reduce_inv_quad else -2)
        ld = None if ld_b is None else ld_b.sum(-1)
        return ((iq, ld), solver_state) if return_state else (iq, ld)

    def logdet(self) -> torch.Tensor:
        return self.base.logdet().sum(-1)

    def cholesky(self, upper: bool = False) -> "BlockDiagLinearOperator":
        return type(self)(self.base.cholesky(upper=upper))

    def root_decomposition(self, method=None):
        """R Rᵀ = self for R the blocks' roots laid out as this operator lays out its blocks
        (dense: (..., B·n, B·k))."""
        from .root import RootLinearOperator

        root = self.base.root_decomposition(method).root
        return RootLinearOperator(type(self)(DenseLinearOperator(root)).to_dense())

    def add_diagonal(self, diag):
        diag = torch.as_tensor(diag, dtype=self.dtype, device=self.device)
        if diag.ndim == 0 or diag.shape[-1] == 1:
            return type(self)(self.base.add_diagonal(diag.reshape(diag.shape[:-1] + (1, 1)) if diag.ndim else diag))
        if diag.shape[-1] == self.shape[-1]:
            return type(self)(self.base.add_diagonal(self._blockify(diag.unsqueeze(-1)).squeeze(-1)))
        return super().add_diagonal(diag)


class BlockInterleavedLinearOperator(BlockDiagLinearOperator):
    """The block-diagonal matrix in the interleaved layout: index i·B + b is block b, row i."""

    def _blockify(self, rhs):
        x = rhs.reshape(rhs.shape[:-2] + (self.base.shape[-1], self.num_blocks, rhs.shape[-1]))
        return x.transpose(-3, -2)  # (..., B, n, k)

    def _unblockify(self, x):
        y = x.transpose(-3, -2)  # (..., m, B, k)
        return y.reshape(y.shape[:-3] + (y.shape[-3] * y.shape[-2], y.shape[-1]))

    def _diagonal(self):
        d = self.base._diagonal().transpose(-1, -2)  # (..., n, B)
        return d.reshape(d.shape[:-2] + (d.shape[-2] * d.shape[-1],))

    def to_dense(self):
        # dense[i·B + b, j·B + c] = δ_bc K_b[i, j]
        Kb = self.base.to_dense()
        B, n, m = Kb.shape[-3:]
        eye = torch.eye(B, dtype=Kb.dtype, device=Kb.device)
        big = (Kb.unsqueeze(-3) * eye[:, :, None, None]).permute(*range(Kb.ndim - 3), -2, -4, -1, -3)
        return big.reshape(Kb.shape[:-3] + (n * B, m * B))
