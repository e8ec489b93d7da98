from .gaussian_likelihood import GaussianLikelihood, HadamardGaussianLikelihood
from .likelihood import Likelihood
from .multitask_gaussian_likelihood import MultitaskGaussianLikelihood
from .noise_models import HomoskedasticNoise, MultitaskHomoskedasticNoise

__all__ = ["GaussianLikelihood", "HadamardGaussianLikelihood", "HomoskedasticNoise", "Likelihood",
           "MultitaskGaussianLikelihood", "MultitaskHomoskedasticNoise"]
