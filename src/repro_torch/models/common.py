"""Shared building blocks of the LM substrate, ported from the JAX
package's ``models/common.py``.

Parameters are plain nested dicts of tensors, the JAX package's trees leaf
for leaf, so carrying weights across (:mod:`repro_torch.interop`) is a walk
of the tree.  Init draws from an explicit ``torch.Generator`` on the
device the parameters live on.

The JAX module's mesh and sharding helpers (``set_mesh``, ``resolve_spec``,
``sanitize_spec``, ``named_sharding``, ``fsdp_spec``, ``constrain``) are not
ported: on one card ``constrain`` is the identity, so the port simply makes
no such call, and ``init`` functions return parameters without specs.
``ModelConfig.fsdp`` is kept as a field and has no effect here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    act: str = "swiglu"            # swiglu | geglu | relu2 | gelu
    attn: str = "full"             # full | swa | chunked
    window: int = 4096             # swa window / chunk size
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    router: str = "topk"           # topk | matching  (paper technique)
    capacity_factor: float = 1.25
    moe_every: int = 1             # MoE layer every k-th block (1 = all)
    moe_shared_expert: bool = False  # always-on shared expert (llama4)
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    # hybrid: one shared attention block every `shared_every` mamba blocks
    shared_every: int = 0
    # encoder-decoder
    enc_layers: int = 0
    # frontends (stubbed per spec: input_specs provides embeddings)
    frontend: str = ""             # "" | "audio" | "vision"
    frontend_len: int = 256        # patches / frames prepended
    # numerics / partitioning
    dtype: str = "bfloat16"
    fsdp: bool = False
    remat: bool = True
    attn_impl: str = "xla"         # xla | pallas (flash kernel)
    # beyond-baseline knobs of the JAX package: the H-flat attention
    # layout (attention.py), the local MoE dispatch (moe.py) and the int8
    # KV cache (attention.py; not for the hybrid, see Model.init_cache)
    opt_attn_layout: bool = False
    opt_moe_dispatch: bool = False
    opt_kv_quant: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dec_layers(self) -> int:
        return self.n_layers

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def tdtype(self) -> torch.dtype:
        """The parameter and activation dtype as a torch dtype."""
        return getattr(torch, self.dtype)

    def params_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        D, F_, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, KV, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = D * hd * (H + 2 * KV) + H * hd * D
        if self.act in ("swiglu", "geglu"):
            mlp = 3 * D * F_
        else:
            mlp = 2 * D * F_
        per = attn + 2 * D
        if self.family == "moe":
            moe_l = self.n_experts * mlp + D * self.n_experts
            n_moe = L // self.moe_every
            per_total = L * per + n_moe * moe_l + (L - n_moe) * mlp
        elif self.family == "ssm":
            di, N, Hs = self.d_inner, self.ssm_state, self.ssm_heads
            per = (D * (2 * di + 2 * N + Hs)      # in_proj (z,x,B,C,dt)
                   + di * D + 2 * D)              # out_proj + norms
            per_total = L * per
        elif self.family == "hybrid":
            di, N, Hs = self.d_inner, self.ssm_state, self.ssm_heads
            mamba = D * (2 * di + 2 * N + Hs) + di * D + 2 * D
            n_shared = 1 if self.shared_every else 0
            per_total = L * mamba + n_shared * (attn + mlp + 2 * D)
        else:
            per_total = L * (per + mlp)
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.enc_layers:
            per_total += self.enc_layers * (attn + mlp + 2 * D)
            per_total += self.n_layers * attn     # cross attention
        return per_total + emb


# ---------------------------------------------------------------------------
# initializers and the shared numerics
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               in_axis=0) -> torch.Tensor:
    """Normal(0, 1/fan_in) drawn in fp32 on ``gen``'s device, cast to
    ``dtype``.  ``fan_in`` is ``shape[in_axis]`` (the JAX package's rule:
    ``wo`` of shape (H, hd, D) has ``fan_in = H``)."""
    axes = [in_axis] if isinstance(in_axis, int) else list(in_axis)
    fan_in = math.prod(shape[i] for i in axes)
    std = 1.0 / math.sqrt(max(1, fan_in))
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(std).to(dtype)       # in place: one fp32 draw alive


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMS norm in fp32 with the ``(1 + scale)`` gain, cast back to x's
    dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation, written op by op
    in x's dtype as JAX defines it.  ``F.gelu(x, approximate="tanh")`` is
    the same function but computes bf16 input in fp32 and rounds once,
    which moves 40 % of bf16 outputs by an ulp against the JAX package;
    torch's default, the exact erf form, is another function."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x ** 3))))
    return x * cdf


def activate(act: str, h: torch.Tensor, g=None) -> torch.Tensor:
    if act == "swiglu":
        return F.silu(g) * h
    if act == "geglu":
        return gelu(g) * h
    if act == "relu2":                       # Nemotron-4 squared ReLU
        return F.relu(h).square()
    if act == "gelu":
        return gelu(h)
    raise ValueError(act)


def rope(q: torch.Tensor, k: torch.Tensor, pos: torch.Tensor, theta: float):
    """Rotary embeddings; q,k: (..., S, H, hd), pos: (..., S) int.  The two
    halves of the head dim are rotated as a pair (concatenated, not
    interleaved), in fp32."""
    hd = q.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=q.device) / half)
    ang = pos[..., :, None].float() * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]

    def rot(x):
        x1, x2 = x[..., :half].float(), x[..., half:].float()
        return torch.cat([x1 * cos - x2 * sin,
                          x2 * cos + x1 * sin], -1).to(x.dtype)

    return rot(q), rot(k)


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------
def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_size(params: Dict) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))
