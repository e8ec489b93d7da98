from .base import DenseLinearOperator, LinearOperator, ProbeSource, probe_base_samples, to_linear_operator
from .diag import ConstantDiagLinearOperator, DiagLinearOperator
from .added_diag import AddedDiagLinearOperator
from .composition import ConstantMulLinearOperator, MaskedLinearOperator, SumLinearOperator
from .lazy_kernel import LazyEvaluatedKernelOperator, join_rows
from .root import LowRankRootAddedDiagLinearOperator, RootLinearOperator
from .triangular import CholLinearOperator, TriangularLinearOperator
from .toeplitz import ToeplitzLinearOperator
from .kronecker import (KroneckerProductAddedDiagLinearOperator, KroneckerProductDiagLinearOperator,
                        KroneckerProductLinearOperator)
from .interpolated import InterpolatedLinearOperator

__all__ = [
    "AddedDiagLinearOperator",
    "CholLinearOperator",
    "ConstantDiagLinearOperator",
    "ConstantMulLinearOperator",
    "DenseLinearOperator",
    "DiagLinearOperator",
    "InterpolatedLinearOperator",
    "KroneckerProductAddedDiagLinearOperator",
    "KroneckerProductDiagLinearOperator",
    "KroneckerProductLinearOperator",
    "LazyEvaluatedKernelOperator",
    "LinearOperator",
    "LowRankRootAddedDiagLinearOperator",
    "MaskedLinearOperator",
    "ProbeSource",
    "RootLinearOperator",
    "SumLinearOperator",
    "ToeplitzLinearOperator",
    "TriangularLinearOperator",
    "join_rows",
    "probe_base_samples",
    "to_linear_operator",
]
