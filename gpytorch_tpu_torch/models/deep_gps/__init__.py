from .deep_gp import DeepGP, DeepGPLayer

__all__ = ["DeepGP", "DeepGPLayer"]
