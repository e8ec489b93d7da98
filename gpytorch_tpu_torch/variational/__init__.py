from ._variational_distribution import (CholeskyVariationalDistribution, DeltaVariationalDistribution,
                                        MeanFieldVariationalDistribution)
from ._variational_strategy import _VariationalStrategy
from .natural_variational_distribution import (NaturalVariationalDistribution, TrilNaturalVariationalDistribution,
                                               natural_to_mu_sigma)
from .variational_strategy import UnwhitenedVariationalStrategy, VariationalStrategy

__all__ = [
    "CholeskyVariationalDistribution",
    "DeltaVariationalDistribution",
    "MeanFieldVariationalDistribution",
    "NaturalVariationalDistribution",
    "TrilNaturalVariationalDistribution",
    "UnwhitenedVariationalStrategy",
    "VariationalStrategy",
    "_VariationalStrategy",
    "natural_to_mu_sigma",
]
