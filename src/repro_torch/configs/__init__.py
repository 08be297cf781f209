"""Architecture registry of the port: the JAX package's ten names, every
one ported (FULL and SMOKE configs copied field for field)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

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
# the architectures whose family the port runs: all of them
PORTED = tuple(_ARCHS)

ARCH_NAMES: List[str] = list(_ARCHS)


def _key(name: str) -> str:
    key = name if name in _ARCHS else name.replace("_", "-")
    if key not in _ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_NAMES}")
    return key


def get_config(name: str, smoke: bool = False, **overrides) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[_key(name)]}")
    cfg = getattr(mod, "SMOKE" if smoke else "FULL")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {n: get_config(n, smoke) for n in ARCH_NAMES}
