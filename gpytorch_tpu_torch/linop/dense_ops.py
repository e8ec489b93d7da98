"""Elementwise (Hadamard) products of operators: what ``LinearOperator.__mul__`` gives for
an operator times an operator, as in a Hadamard multitask model's K_data ⊙ K_task.

Counterpart of ``gpytorch_tpu/linop/dense_ops.py``: a product with a diagonal operator
stays diagonal; any other product is formed densely.
"""

from __future__ import annotations

from .base import DenseLinearOperator, LinearOperator
from .diag import DiagLinearOperator


def hadamard_product(a: LinearOperator, b: LinearOperator) -> LinearOperator:
    """a ⊙ b: diagonal where either factor is, else a ``DenseLinearOperator``."""
    if isinstance(a, DiagLinearOperator) and isinstance(b, DiagLinearOperator):
        return DiagLinearOperator(a._diag_values() * b._diag_values())
    if isinstance(a, DiagLinearOperator):
        return DiagLinearOperator(a._diag_values() * b._diagonal())
    if isinstance(b, DiagLinearOperator):
        return DiagLinearOperator(b._diag_values() * a._diagonal())
    return DenseLinearOperator(a.to_dense() * b.to_dense())
