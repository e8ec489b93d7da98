from ._variational_distribution import (CholeskyVariationalDistribution, DeltaVariationalDistribution,
                                        MeanFieldVariationalDistribution)
from ._variational_strategy import _VariationalStrategy
from .ciq_variational_strategy import CiqVariationalStrategy
from .decoupled_variational_strategies import (BatchDecoupledVariationalStrategy,
                                               OrthogonallyDecoupledVariationalStrategy)
from .grid_interpolation_variational_strategy import (AdditiveGridInterpolationVariationalStrategy,
                                                      GridInterpolationVariationalStrategy)
from .large_batch_variational_strategy import LargeBatchVariationalStrategy, quad_form_diagonal
from .multitask_variational_strategies import IndependentMultitaskVariationalStrategy, LMCVariationalStrategy
from .nearest_neighbor_variational_strategy import NNVariationalStrategy
from .natural_variational_distribution import (NaturalVariationalDistribution, TrilNaturalVariationalDistribution,
                                               natural_to_mu_sigma)
from .variational_strategy import UnwhitenedVariationalStrategy, VariationalStrategy

# the JAX package's (and GPyTorch's deprecated) name of the independent multitask strategy
MultitaskVariationalStrategy = IndependentMultitaskVariationalStrategy

__all__ = [
    "AdditiveGridInterpolationVariationalStrategy",
    "BatchDecoupledVariationalStrategy",
    "CholeskyVariationalDistribution",
    "CiqVariationalStrategy",
    "DeltaVariationalDistribution",
    "GridInterpolationVariationalStrategy",
    "IndependentMultitaskVariationalStrategy",
    "LMCVariationalStrategy",
    "LargeBatchVariationalStrategy",
    "MeanFieldVariationalDistribution",
    "MultitaskVariationalStrategy",
    "NNVariationalStrategy",
    "NaturalVariationalDistribution",
    "OrthogonallyDecoupledVariationalStrategy",
    "TrilNaturalVariationalDistribution",
    "UnwhitenedVariationalStrategy",
    "VariationalStrategy",
    "_VariationalStrategy",
    "natural_to_mu_sigma",
    "quad_form_diagonal",
]
