"""The LM substrate of the port: the dense, MoE, SSM, hybrid, enc-dec and
vision-prefix families."""
from .common import ModelConfig
from .transformer import Model, build_model

__all__ = ["ModelConfig", "Model", "build_model"]
