from .multivariate_normal import MultivariateNormal
from .multitask_multivariate_normal import MultitaskMultivariateNormal

__all__ = ["MultitaskMultivariateNormal", "MultivariateNormal"]
