from .base import DenseLinearOperator, LinearOperator, ProbeSource, probe_base_samples, to_linear_operator
from .diag import ConstantDiagLinearOperator, DiagLinearOperator
from .added_diag import AddedDiagLinearOperator
from .composition import ConstantMulLinearOperator, MaskedLinearOperator, SumLinearOperator
from .lazy_kernel import LazyEvaluatedKernelOperator, join_rows
from .root import LowRankRootAddedDiagLinearOperator, RootLinearOperator
from .triangular import CholLinearOperator, TriangularLinearOperator

__all__ = [
    "AddedDiagLinearOperator",
    "CholLinearOperator",
    "ConstantDiagLinearOperator",
    "ConstantMulLinearOperator",
    "DenseLinearOperator",
    "DiagLinearOperator",
    "LazyEvaluatedKernelOperator",
    "LinearOperator",
    "LowRankRootAddedDiagLinearOperator",
    "MaskedLinearOperator",
    "ProbeSource",
    "RootLinearOperator",
    "SumLinearOperator",
    "TriangularLinearOperator",
    "join_rows",
    "probe_base_samples",
    "to_linear_operator",
]
