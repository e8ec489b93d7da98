from .exact_marginal_log_likelihood import ExactMarginalLogLikelihood
from .marginal_log_likelihood import MarginalLogLikelihood

__all__ = ["ExactMarginalLogLikelihood", "MarginalLogLikelihood"]
