from ._variational_distribution import (CholeskyVariationalDistribution, DeltaVariationalDistribution,
                                        MeanFieldVariationalDistribution)
from ._variational_strategy import _VariationalStrategy
from .ciq_variational_strategy import CiqVariationalStrategy
from .nearest_neighbor_variational_strategy import NNVariationalStrategy
from .natural_variational_distribution import (NaturalVariationalDistribution, TrilNaturalVariationalDistribution,
                                               natural_to_mu_sigma)
from .variational_strategy import UnwhitenedVariationalStrategy, VariationalStrategy

__all__ = [
    "CholeskyVariationalDistribution",
    "CiqVariationalStrategy",
    "DeltaVariationalDistribution",
    "MeanFieldVariationalDistribution",
    "NNVariationalStrategy",
    "NaturalVariationalDistribution",
    "TrilNaturalVariationalDistribution",
    "UnwhitenedVariationalStrategy",
    "VariationalStrategy",
    "_VariationalStrategy",
    "natural_to_mu_sigma",
]
