from .base import DenseLinearOperator, LinearOperator, ProbeSource, probe_base_samples, to_linear_operator
from .diag import ConstantDiagLinearOperator, DiagLinearOperator, IdentityLinearOperator
from .added_diag import AddedDiagLinearOperator
from .composition import (BatchRepeatLinearOperator, CatLinearOperator, ConstantMulLinearOperator,
                          MaskedLinearOperator, MatmulLinearOperator, SumLinearOperator)
from .block import BlockDiagLinearOperator, BlockInterleavedLinearOperator
from .dense_ops import hadamard_product
from .lazy_kernel import LazyEvaluatedKernelOperator, join_rows
from .root import LowRankRootAddedDiagLinearOperator, LowRankRootLinearOperator, RootLinearOperator
from .triangular import CholLinearOperator, TriangularLinearOperator
from .toeplitz import ToeplitzLinearOperator
from .kronecker import (KroneckerProductAddedDiagLinearOperator, KroneckerProductDiagLinearOperator,
                        KroneckerProductLinearOperator)
from .interpolated import InterpolatedLinearOperator
from .zero import ZeroLinearOperator

__all__ = [
    "AddedDiagLinearOperator",
    "BatchRepeatLinearOperator",
    "BlockDiagLinearOperator",
    "BlockInterleavedLinearOperator",
    "CatLinearOperator",
    "CholLinearOperator",
    "ConstantDiagLinearOperator",
    "ConstantMulLinearOperator",
    "DenseLinearOperator",
    "DiagLinearOperator",
    "IdentityLinearOperator",
    "InterpolatedLinearOperator",
    "KroneckerProductAddedDiagLinearOperator",
    "KroneckerProductDiagLinearOperator",
    "KroneckerProductLinearOperator",
    "LazyEvaluatedKernelOperator",
    "LinearOperator",
    "LowRankRootAddedDiagLinearOperator",
    "LowRankRootLinearOperator",
    "MaskedLinearOperator",
    "MatmulLinearOperator",
    "ProbeSource",
    "RootLinearOperator",
    "SumLinearOperator",
    "ToeplitzLinearOperator",
    "TriangularLinearOperator",
    "ZeroLinearOperator",
    "hadamard_product",
    "join_rows",
    "probe_base_samples",
    "to_linear_operator",
]
