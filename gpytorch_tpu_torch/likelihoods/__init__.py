from .gaussian_likelihood import (DirichletClassificationLikelihood, FixedNoiseGaussianLikelihood, GaussianLikelihood,
                                  GaussianLikelihoodWithMissingObs, HadamardGaussianLikelihood)
from .likelihood import Likelihood
from .multitask_gaussian_likelihood import MultitaskGaussianLikelihood
from .noise_models import (FixedGaussianNoise, HeteroskedasticNoise, HomoskedasticNoise, MultitaskHomoskedasticNoise,
                           Noise)

__all__ = ["DirichletClassificationLikelihood", "FixedGaussianNoise", "FixedNoiseGaussianLikelihood",
           "GaussianLikelihood", "GaussianLikelihoodWithMissingObs", "HadamardGaussianLikelihood",
           "HeteroskedasticNoise", "HomoskedasticNoise", "Likelihood", "MultitaskGaussianLikelihood",
           "MultitaskHomoskedasticNoise", "Noise"]
