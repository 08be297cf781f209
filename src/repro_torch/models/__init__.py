"""The LM substrate of the port: the dense decoder-only family."""
from .common import ModelConfig
from .transformer import Model, build_model

__all__ = ["ModelConfig", "Model", "build_model"]
