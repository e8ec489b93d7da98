from . import deep_gps
from .approximate_gp import ApproximateGP
from .deep_gps import DSPP, DSPPLayer, DeepGP, DeepGPLayer
from .exact_gp import ExactGP
from .exact_prediction_strategies import (DefaultPredictionStrategy, LinearPredictionStrategy, SGPRPredictionStrategy,
                                          prediction_strategy)
from .gp import GP
from .gplvm import (BayesianGPLVM, LatentVariable, MAPLatentVariable, PointLatentVariable,
                    VariationalLatentVariable)
from .model_list import AbstractModelList, IndependentModelList

__all__ = ["AbstractModelList", "ApproximateGP", "BayesianGPLVM", "DSPP", "DSPPLayer", "DeepGP", "DeepGPLayer",
           "DefaultPredictionStrategy", "ExactGP", "GP", "IndependentModelList", "LatentVariable",
           "LinearPredictionStrategy", "MAPLatentVariable", "PointLatentVariable", "SGPRPredictionStrategy",
           "VariationalLatentVariable", "deep_gps", "prediction_strategy"]
