from .steps import (build_prefill_step, build_serve_step, build_train_step,
                    cross_entropy)

__all__ = ["build_prefill_step", "build_serve_step", "build_train_step",
           "cross_entropy"]
