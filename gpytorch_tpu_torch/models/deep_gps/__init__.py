from .deep_gp import DeepGP, DeepGPLayer
from .dspp import DSPP, DSPPLayer

__all__ = ["DSPP", "DSPPLayer", "DeepGP", "DeepGPLayer"]
