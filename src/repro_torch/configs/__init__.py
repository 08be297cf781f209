"""Architecture registry of the port: the JAX package's ten names, of
which the dense family (full attention and sliding window) and the MoE
family are ported (FULL and SMOKE configs copied field for field).
``get_config`` for any other architecture raises and names the ROADMAP
item that will port it."""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.models.common import ModelConfig

_ARCHS = {
    "seamless-m4t-medium": "seamless_m4t_medium",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "nemotron-4-340b": "nemotron_4_340b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "granite-20b": "granite_20b",
    "zamba2-7b": "zamba2_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "dbrx-132b": "dbrx_132b",
    "paligemma-3b": "paligemma_3b",
    "mamba2-2.7b": "mamba2_2_7b",
}
# the architectures whose family the port runs
PORTED = ("h2o-danube-1.8b", "nemotron-4-340b", "deepseek-coder-33b",
          "granite-20b", "llama4-maverick-400b-a17b", "dbrx-132b")
# what each of the others waits for (all ROADMAP.md, Queue 1, item 7)
_WAITS = {
    "seamless-m4t-medium": "the encoder-decoder family",
    "zamba2-7b": "the hybrid SSM family",
    "paligemma-3b": "the vision-prefix family",
    "mamba2-2.7b": "the SSM family",
}

ARCH_NAMES: List[str] = list(_ARCHS)


def _key(name: str) -> str:
    key = name if name in _ARCHS else name.replace("_", "-")
    if key not in _ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_NAMES}")
    return key


def get_config(name: str, smoke: bool = False, **overrides) -> ModelConfig:
    key = _key(name)
    if key not in PORTED:
        raise NotImplementedError(
            f"{key} is not ported yet: it waits for {_WAITS[key]} "
            f"(ROADMAP.md, Queue 1, item 7)")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[key]}")
    cfg = getattr(mod, "SMOKE" if smoke else "FULL")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
