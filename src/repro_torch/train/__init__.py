from .steps import build_prefill_step, build_serve_step

__all__ = ["build_prefill_step", "build_serve_step"]
