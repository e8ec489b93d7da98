from . import deep_gps
from .approximate_gp import ApproximateGP
from .deep_gps import DSPP, DSPPLayer, DeepGP, DeepGPLayer
from .exact_gp import ExactGP
from .exact_prediction_strategies import (DefaultPredictionStrategy, LinearPredictionStrategy, SGPRPredictionStrategy,
                                          prediction_strategy)
from .gp import GP

__all__ = ["ApproximateGP", "DSPP", "DSPPLayer", "DeepGP", "DeepGPLayer", "DefaultPredictionStrategy", "ExactGP", "GP",
           "LinearPredictionStrategy", "SGPRPredictionStrategy", "deep_gps", "prediction_strategy"]
