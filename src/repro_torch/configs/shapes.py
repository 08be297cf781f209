"""The assigned input-shape set and per-(arch, shape) applicability rules
(the JAX package's ``configs/shapes.py``).

  train_4k     seq=4096    global_batch=256   -> train_step
  prefill_32k  seq=32768   global_batch=32    -> prefill (forward)
  decode_32k   seq=32768   global_batch=128   -> serve_step (1 tok, KV 32k)
  long_500k    seq=524288  global_batch=1     -> serve_step, sub-quadratic only

``input_specs`` gives (shape, dtype) pairs where the JAX function gives
``ShapeDtypeStruct``s; ``make_inputs`` draws from a ``torch.Generator``
(tokens as int64, the index type of torch).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq: int
    batch: int
    kind: str                      # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def sub_quadratic(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid") or cfg.attn in ("swa", "chunked")


def applicable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape.name == "long_500k" and not sub_quadratic(cfg):
        return False, "full attention is quadratic at 500k"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeCell
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every model input of this cell.  Train/prefill:
    the token batch (plus labels for train), the stub frontend's patch
    embeddings for the vision prefix (which take ``frontend_len`` of the
    ``seq`` positions) and the encoder's frame embeddings for enc-dec,
    both in the model dtype; decode: one token."""
    B, S = shape.batch, shape.seq
    emb = cfg.tdtype
    if shape.kind in ("train", "prefill"):
        specs = {}
        s_text = S
        if cfg.frontend == "vision":
            s_text = S - cfg.frontend_len
            specs["frontend"] = ((B, cfg.frontend_len, cfg.d_model), emb)
        specs["tokens"] = ((B, s_text), torch.int64)
        if cfg.enc_layers:
            specs["enc_frames"] = (
                (B, max(cfg.frontend_len, S // 4), cfg.d_model), emb)
        if shape.kind == "train":
            specs["labels"] = ((B, s_text), torch.int64)
        return specs
    return {"tokens": ((B, 1), torch.int64)}


def make_inputs(cfg: ModelConfig, shape: ShapeCell, seed: int = 0,
                device=None) -> Dict[str, torch.Tensor]:
    """Concrete random inputs matching ``input_specs``, drawn in its order
    from a generator seeded with ``seed`` on the target device: tokens
    uniform over the vocab, embeddings standard normal (drawn in float32,
    cast to the model dtype)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for name, (shp, dtype) in input_specs(cfg, shape).items():
        if dtype.is_floating_point:
            out[name] = torch.randn(shp, generator=gen, dtype=torch.float32,
                                    device=dev).to(dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab, shp, generator=gen,
                                      dtype=dtype, device=dev)
    return out
