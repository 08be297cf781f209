"""Dense feed-forward blocks: SwiGLU / GeGLU / squared-ReLU / GELU (the
JAX package's ``models/mlp.py``)."""
from __future__ import annotations

import torch

from .common import ModelConfig, activate, dense_init


def init_mlp(gen: torch.Generator, cfg: ModelConfig):
    D, F = cfg.d_model, cfg.d_ff
    dt = cfg.tdtype
    params = {"w_in": dense_init(gen, (D, F), dt),
              "w_out": dense_init(gen, (F, D), dt)}
    if cfg.act in ("swiglu", "geglu"):
        params["w_gate"] = dense_init(gen, (D, F), dt)
    return params


def mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, params["w_in"])
    g = None
    if cfg.act in ("swiglu", "geglu"):
        g = torch.einsum("bsd,df->bsf", x, params["w_gate"])
    h = activate(cfg.act, h, g)
    return torch.einsum("bsf,fd->bsd", h, params["w_out"])
