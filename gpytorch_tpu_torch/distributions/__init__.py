from .delta import Delta
from .multivariate_normal import MultivariateNormal, kl_divergence
from .multitask_multivariate_normal import MultitaskMultivariateNormal

__all__ = ["Delta", "MultitaskMultivariateNormal", "MultivariateNormal", "kl_divergence"]
