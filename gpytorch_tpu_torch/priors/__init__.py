from .horseshoe_prior import HorseshoePrior
from .lkj_prior import LKJCholeskyFactorPrior, LKJCovariancePrior, LKJPrior
from .prior import Prior
from .smoothed_box_prior import SmoothedBoxPrior
from .torch_priors import (
    GammaPrior,
    HalfCauchyPrior,
    HalfNormalPrior,
    LogNormalPrior,
    MultivariateNormalPrior,
    NormalPrior,
    UniformPrior,
)
from .wishart_prior import InverseWishartPrior, WishartPrior

__all__ = [
    "GammaPrior",
    "HalfCauchyPrior",
    "HalfNormalPrior",
    "HorseshoePrior",
    "InverseWishartPrior",
    "LKJCholeskyFactorPrior",
    "LKJCovariancePrior",
    "LKJPrior",
    "LogNormalPrior",
    "MultivariateNormalPrior",
    "NormalPrior",
    "Prior",
    "SmoothedBoxPrior",
    "UniformPrior",
    "WishartPrior",
]
