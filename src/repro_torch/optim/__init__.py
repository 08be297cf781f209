"""The optimizer of the training path: AdamW (with its factored branch)
and int8 gradient compression."""
from .adamw import (OptConfig, adamw_init, adamw_update, state_cuts,
                    zero1_dim, zero1_dims)
from .compress import compress_grads, decompress_grads

__all__ = ["adamw_init", "adamw_update", "OptConfig", "compress_grads",
           "decompress_grads", "zero1_dim", "zero1_dims", "state_cuts"]
