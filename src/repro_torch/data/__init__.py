from .pipeline import DataConfig, make_batches, synthetic_batch

__all__ = ["DataConfig", "make_batches", "synthetic_batch"]
