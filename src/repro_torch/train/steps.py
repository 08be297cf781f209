"""Step functions of the serving path (the JAX package's ``train/steps.py``:
``build_prefill_step`` and ``build_serve_step``).  The train step and
``cross_entropy`` belong to the training slice (ROADMAP.md, Queue 1,
item 9).  PyTorch runs eagerly, so ``build_*`` returns the plain function
where the JAX one returns the function that is then jitted."""
from __future__ import annotations

from repro_torch.models import Model


def build_prefill_step(model: Model):
    """Serving prefill: full forward, next-token logits only (the MoE
    family's ``aux`` is dropped here, as in the JAX package).  ``batch``
    carries what the model's forward takes: ``tokens``, and the vision
    prefix's ``frontend`` or the enc-dec's ``enc_frames``."""
    def prefill(params, batch):
        logits, _ = model.forward(params, batch, last_only=True)
        return logits

    return prefill


def build_serve_step(model: Model):
    """One decode step: (params, cache, tokens) -> (logits, cache)."""
    def serve(params, cache, tokens):
        return model.decode_step(params, cache, tokens, cache["pos"])

    return serve
