"""Batched serving: prefill a batch of prompts by stepping, then a
greedy decode loop (the JAX package's ``launch/serve.py``).

``python -m repro_torch.launch.serve --arch granite-20b --smoke --batch 4
--prompt-len 16 --gen 16 [--device cpu]`` runs real generation with the KV
cache (the SSM state and convolution caches for mamba2 and zamba2; for
seamless the encoder first fills the cross-attention cache).  As in the
JAX package's loop the prompt is fed one token per step through the serve
step; there is no cache-filling prefill.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.shapes import ShapeCell, make_inputs
from repro_torch.models import Model, build_model
from repro_torch.train import build_serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model: Model, params, tokens: torch.Tensor, gen: int,
             max_len: int = 0, enc_frames: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Step the (B, P) prompt through the serve step, then decode ``gen``
    tokens greedily.  An enc-dec model first runs its encoder over
    ``enc_frames`` (B, Se, D) into the cross-attention cache
    (``prefill_encoder``).  Returns the (B, gen) generated tokens (on the
    prompt's device) and host-clock seconds of the phases."""
    B, P = tokens.shape
    dev = tokens.device
    enc = model.cfg.enc_layers > 0
    if enc and enc_frames is None:
        raise ValueError(f"{model.cfg.name} is an encoder-decoder: "
                         f"generate needs its enc_frames")
    cache = model.init_cache(B, max_len or (P + gen),
                             enc_len=enc_frames.shape[1] if enc else 0,
                             device=dev)
    serve_step = build_serve_step(model)
    _sync(dev)
    t_enc = time.perf_counter()
    if enc:
        cache = model.prefill_encoder(params, cache,
                                      {"enc_frames": enc_frames})
        _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(P):
        logits, cache = serve_step(params, cache, tokens[:, t:t + 1])
    nxt = torch.argmax(logits[:, -1:], dim=-1)
    _sync(dev)
    t1 = time.perf_counter()
    gen_toks = [nxt]
    for _ in range(gen - 1):
        logits, cache = serve_step(params, cache, nxt)
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        gen_toks.append(nxt)
    out = torch.cat(gen_toks, dim=1)
    _sync(dev)
    t2 = time.perf_counter()
    return out, {"encoder_s": t0 - t_enc, "prompt_steps": P,
                 "prompt_s": t1 - t0, "gen_steps": gen - 1, "gen_s": t2 - t1}


def run(arch: str, smoke: bool, batch: int, prompt_len: int, gen: int,
        max_len: int = 0, seed: int = 0, device=None) -> np.ndarray:
    """Build the config and seeded weights, draw the prompts (and an
    enc-dec model's frames), generate greedily.  As in the JAX package a
    vision model's ``prompt_len`` counts its ``frontend_len`` patch
    positions, which the stepped prompt leaves out."""
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg)
    params = model.init(seed, device=device)
    dev = params["embed"]["tok"].device
    shape = ShapeCell("serve", prompt_len, batch, "prefill")
    inputs = make_inputs(cfg, shape, seed=seed, device=dev)
    out, t = generate(model, params, inputs["tokens"], gen, max_len,
                      enc_frames=inputs.get("enc_frames"))
    total = t["prompt_steps"] + t["gen_steps"]
    dt = t["prompt_s"] + t["gen_s"]
    print(f"[serve] {arch}: batch={batch} steps={total} "
          f"({dt / total * 1000:.1f} ms/step incl. host loop)")
    return out.cpu().numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args()
    run(args.arch, args.smoke, args.batch, args.prompt_len, args.gen,
        device=args.device)


if __name__ == "__main__":
    main()
