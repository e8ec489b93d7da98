from .gaussian_likelihood import (DirichletClassificationLikelihood, FixedNoiseGaussianLikelihood, GaussianLikelihood,
                                  GaussianLikelihoodWithMissingObs, HadamardGaussianLikelihood)
from .likelihood import Likelihood, LikelihoodList, _OneDimensionalLikelihood
from .multitask_gaussian_likelihood import MultitaskGaussianLikelihood
from .noise_models import (FixedGaussianNoise, HeteroskedasticNoise, HomoskedasticNoise, MultitaskHomoskedasticNoise,
                           Noise)
from .non_gaussian import (BernoulliLikelihood, BetaLikelihood, LaplaceLikelihood, NegativeBinomialLikelihood,
                           PoissonLikelihood, SoftmaxLikelihood, StudentTLikelihood)

__all__ = ["BernoulliLikelihood", "BetaLikelihood", "DirichletClassificationLikelihood", "FixedGaussianNoise",
           "FixedNoiseGaussianLikelihood", "GaussianLikelihood", "GaussianLikelihoodWithMissingObs",
           "HadamardGaussianLikelihood", "HeteroskedasticNoise", "HomoskedasticNoise", "LaplaceLikelihood",
           "Likelihood", "LikelihoodList", "MultitaskGaussianLikelihood", "MultitaskHomoskedasticNoise",
           "NegativeBinomialLikelihood", "Noise", "PoissonLikelihood", "SoftmaxLikelihood", "StudentTLikelihood",
           "_OneDimensionalLikelihood"]
