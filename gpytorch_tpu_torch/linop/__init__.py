from .base import DenseLinearOperator, LinearOperator, probe_base_samples, to_linear_operator
from .diag import ConstantDiagLinearOperator, DiagLinearOperator
from .added_diag import AddedDiagLinearOperator
from .composition import ConstantMulLinearOperator, SumLinearOperator
from .lazy_kernel import LazyEvaluatedKernelOperator, join_rows
from .root import LowRankRootAddedDiagLinearOperator, RootLinearOperator

__all__ = [
    "AddedDiagLinearOperator",
    "ConstantDiagLinearOperator",
    "ConstantMulLinearOperator",
    "DenseLinearOperator",
    "DiagLinearOperator",
    "LazyEvaluatedKernelOperator",
    "LinearOperator",
    "LowRankRootAddedDiagLinearOperator",
    "RootLinearOperator",
    "SumLinearOperator",
    "join_rows",
    "probe_base_samples",
    "to_linear_operator",
]
