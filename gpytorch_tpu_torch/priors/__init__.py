from .prior import Prior
from .torch_priors import (
    GammaPrior,
    HalfCauchyPrior,
    HalfNormalPrior,
    LogNormalPrior,
    MultivariateNormalPrior,
    NormalPrior,
    UniformPrior,
)

__all__ = [
    "GammaPrior",
    "HalfCauchyPrior",
    "HalfNormalPrior",
    "LogNormalPrior",
    "MultivariateNormalPrior",
    "NormalPrior",
    "Prior",
    "UniformPrior",
]
