from .added_loss_term import (AddedLossTerm, InducingPointKernelAddedLossTerm, KLGaussianAddedLossTerm,
                              NoiseModelAddedLossTerm)
from .deep_approximate_mll import DeepApproximateMLL, DeepPredictiveLogLikelihood
from .exact_marginal_log_likelihood import ExactMarginalLogLikelihood
from .leave_one_out_pseudo_likelihood import LeaveOneOutPseudoLikelihood
from .marginal_log_likelihood import MarginalLogLikelihood
from .predictive_log_likelihood import PredictiveLogLikelihood
from .sum_marginal_log_likelihood import SumMarginalLogLikelihood
from .variational_elbo import GammaRobustVariationalELBO, VariationalELBO

__all__ = ["AddedLossTerm", "DeepApproximateMLL", "DeepPredictiveLogLikelihood", "ExactMarginalLogLikelihood",
           "GammaRobustVariationalELBO", "InducingPointKernelAddedLossTerm", "KLGaussianAddedLossTerm",
           "LeaveOneOutPseudoLikelihood", "MarginalLogLikelihood", "NoiseModelAddedLossTerm", "PredictiveLogLikelihood",
           "SumMarginalLogLikelihood", "VariationalELBO"]
