from . import deep_gps
from .approximate_gp import ApproximateGP
from .exact_gp import ExactGP
from .exact_prediction_strategies import DefaultPredictionStrategy, prediction_strategy
from .gp import GP

__all__ = ["ApproximateGP", "DefaultPredictionStrategy", "ExactGP", "GP", "deep_gps", "prediction_strategy"]
