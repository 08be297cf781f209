"""The LM substrate of the port: the dense and MoE decoder-only families."""
from .common import ModelConfig
from .transformer import Model, build_model

__all__ = ["ModelConfig", "Model", "build_model"]
