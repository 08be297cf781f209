"""Shared building blocks of the LM substrate, ported from the JAX
package's ``models/common.py``.

Parameters are plain nested dicts of tensors, the JAX package's trees leaf
for leaf, so carrying weights across (:mod:`repro_torch.interop`) is a walk
of the tree.  Init draws from an explicit ``torch.Generator`` on the
device the parameters live on.

The JAX module's mesh helpers (``set_mesh``, ``resolve_spec``,
``named_sharding``, ``constrain``) have no counterpart: GSPMD places a
tensor by its spec, and here each rank of a world holds its own slices and
calls the collectives itself.  What the reference's specs and
``fsdp_spec`` say is :func:`leaf_place`: for each leaf of the params tree,
the dim the ``model`` axis cuts and the dim the ``data`` axis cuts (FSDP,
where ``cfg.fsdp``), as a :class:`Place`; :class:`Par` is a model's view
of a world (its axes, FSDP, sequence parallelism).

Where ``M`` does not divide a dim, the reference's ``sanitize_spec`` moves
the axis to another dim and GSPMD picks the collectives; at a 16 x 16 mesh
deepseek-coder-33b's ``wq``/``wk``/``wv`` ``(L, d, H, hd)`` are cut on
``hd`` and ``wo`` on ``d``, paligemma-3b's on ``d`` and ``hd``,
llama4-maverick's on the layer axis ``L``.  The port has one rule of its
own instead, which keeps its tensor-parallel path and its collectives:
every dim the model axis cuts goes in blocks of ``ceil(n / M)``, the last
block short or empty (query heads, ``d_ff``, the padded vocab; rank ``i``
holds ``[i * block, min((i + 1) * block, n))``), and K/V heads that ``M``
does not divide are replicated over ``model`` (each rank reads the ones
its query heads read, :meth:`Par.kv_range`).  The values are the
reference's, in another layout; a save holds whole leaves in either
package.  Experts and SSM heads go in blocks of ``ceil(n / M)`` too, and
the SSM's ``d_inner`` in blocks of whole heads, ``ceil(Hs / M) *
ssm_headdim`` channels (:func:`leaf_place`), so that no head is cut in
two.  So every configuration takes every ``M``
(:func:`check_model_axis`).  Every family takes the axis: the MoE
family's experts are cut over it (the expert axis, the router whole), the
SSM's ``d_inner`` and heads (the B/C projections whole), and the hybrid's
shared attention block is placed as an attention block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

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
class MetaDraws:
    """The generator of an init on the ``meta`` device (the dry run): its
    draws have shapes and no values (torch has no meta generator)."""

    device = torch.device("meta")


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               in_axis=0) -> torch.Tensor:
    """Normal(0, 1/fan_in) drawn in fp32 on ``gen``'s device, cast to
    ``dtype``.  ``fan_in`` is ``shape[in_axis]`` (the JAX package's rule:
    ``wo`` of shape (H, hd, D) has ``fan_in = H``).  On ``meta``
    (:class:`MetaDraws`) an empty tensor of the shape."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=gen.device)
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


def tree_map_paths(fn: Callable, tree: Any,
                   prefix: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` on every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map_paths(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree)


# ---------------------------------------------------------------------------
# placement over a world's mesh (the reference's specs and fsdp_spec)
# ---------------------------------------------------------------------------
# (dim, axis name, whole length, block): rank i along the axis holds
# [i * block, min((i + 1) * block, whole)) of the dim
Cut = Tuple[int, str, int, int]


@dataclasses.dataclass(frozen=True)
class Place:
    """Where a leaf lives over a world's mesh: its ``cuts`` (at most one
    over ``model``, one over ``data``) and ``sum_model``: the leaf is whole
    on every model rank, but each rank's gradient of it is a part (the
    K/V weights replicated over ``model``; the MoE router, whose combine
    weights each rank takes for its own experts' instances; the SSM's B/C
    projections and convolutions, which each rank reads for its own heads;
    under sequence parallelism the norm scales), which the train step sums
    over ``model``."""

    cuts: Tuple[Cut, ...] = ()
    sum_model: bool = False

    def dim(self, axis: str) -> Optional[int]:
        """The dim ``axis`` cuts (None: whole over it)."""
        return next((c[0] for c in self.cuts if c[1] == axis), None)

    @property
    def model(self) -> Optional[int]:
        return self.dim("model")

    @property
    def data(self) -> Optional[int]:
        return self.dim("data")


def axis_range(whole: int, block: int, index: int) -> Tuple[int, int]:
    """``[lo, hi)`` of rank ``index``'s block of a dim (module doc)."""
    lo = min(whole, index * block)
    return lo, min(whole, lo + block)


def _whole_shape(path: Tuple[str, ...], cfg: ModelConfig) -> Tuple[int, ...]:
    """The whole shape of the (unstacked) leaf at ``path``."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    F_, E, name = cfg.d_ff, cfg.n_experts, path[-1]
    if "mix" in path:                              # the SSM block
        di, N, Hs, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
        return {"wz": (d, di), "wx": (d, di), "wB": (d, N), "wC": (d, N),
                "wdt": (d, Hs), "conv_x": (K, di), "conv_B": (K, N),
                "conv_C": (K, N), "A_log": (Hs,), "Dp": (Hs,),
                "dt_bias": (Hs,), "norm": (di,), "out": (di, d)}[name]
    if "ffn" in path and cfg.family == "moe" and path[0] != "shared":
        return {"router": (d, E), "w_in": (E, d, F_), "w_gate": (E, d, F_),
                "w_out": (E, F_, d), "sh_in": (d, F_), "sh_gate": (d, F_),
                "sh_out": (F_, d)}[name]
    return {"wq": (d, H, hd), "wk": (d, KV, hd), "wv": (d, KV, hd),
            "wo": (H, hd, d), "w_in": (d, F_), "w_gate": (d, F_),
            "w_out": (F_, d), "tok": (cfg.vocab, d),
            "unembed": (d, cfg.vocab), "vproj": (d, d)}.get(name, (d,))


def model_block(whole: int, m: int) -> int:
    """The block of a dim of ``whole`` over a model axis of ``m`` ranks:
    ``ceil(whole / m)``, the last rank's block short or empty (module
    doc)."""
    return -(-whole // m)


def check_model_axis(cfg: ModelConfig, m: int) -> None:
    """A model axis of ``m`` ranks: every configuration takes any ``m >=
    1`` (ceil blocks, module doc); an axis of no ranks is refused."""
    if m < 1:
        raise ValueError(f"{cfg.name}: a model axis of {m} ranks")


def vocab_padded(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 128, as in the JAX package (there
    so logits cut over the model axis; here too).  Params keep the exact
    vocab."""
    return -(-cfg.vocab // 128) * 128


_FSDP = ("wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out", "unembed",
         "sh_in", "sh_gate", "sh_out", "wz", "wx", "out")
_NORMS = ("ln1", "ln2", "lnx", "ln_f")
# the dim the model axis cuts, by leaf name (of the unstacked leaf)
_MODEL_DIM = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "w_in": 1, "w_gate": 1,
              "w_out": 0, "tok": 0, "unembed": 1, "sh_in": 1, "sh_gate": 1,
              "sh_out": 0, "wz": 1, "wx": 1, "wdt": 1, "conv_x": 1,
              "A_log": 0, "Dp": 0, "dt_bias": 0, "norm": 0, "out": 0}
# the SSM's d_inner leaves, cut in blocks of whole heads
_D_INNER = ("wz", "wx", "conv_x", "norm", "out")
# whole on every model rank, each rank's gradient a part: the MoE router
# and the SSM's B/C projections and convolutions
_SUM_MODEL = ("router", "wB", "wC", "conv_B", "conv_C")


def leaf_place(path: Tuple[str, ...], cfg: ModelConfig,
               mesh: Tuple[int, int]) -> Place:
    """The :class:`Place` of the params leaf at ``path`` over a mesh ``(D,
    M)`` (module doc): the reference's spec of the leaf (``P(None, model,
    None)`` for ``wq``, ``wk``, ``wv``; ``P(model, None, None)`` for
    ``wo``; ``P(None, model)`` / ``P(model, None)`` for the MLP's in and
    out and the MoE shared expert's; ``P(model, None)`` for ``tok``,
    ``P(None, model)`` for ``unembed``; the experts ``P(model, None,
    None)``; the SSM's ``wz``, ``wx``, ``wdt``, ``conv_x`` on their last
    dim, its head vectors, ``norm`` and ``out`` on their first), shifted by
    one for the stacked ``(L, ...)`` leaves as ``P(None, *s)``, and with
    ``fsdp_spec``'s data axis on the first dim the model axis leaves free
    (the first that ``D`` divides); the model blocks ``ceil(n / M)``
    (:func:`model_block`; the vocab's of the padded vocab; ``d_inner``'s
    of whole SSM heads, ``ceil(Hs / M) * ssm_headdim``), K/V heads that
    ``M`` does not divide whole (``sum_model``); under
    ``opt_moe_dispatch`` the experts' ``w_in`` and ``w_gate`` take it on
    ``d_ff`` (the reference's ``P(model, None, data)``)."""
    d, m = mesh
    name = path[-1]
    stacked = path[0] in ("layers", "enc")
    shape = _whole_shape(path, cfg)
    if stacked:
        shape = ((cfg.n_layers if path[0] == "layers" else cfg.enc_layers),
                 ) + shape
    off = 1 if stacked else 0
    experts = len(shape) - off == 3 and name in ("w_in", "w_gate", "w_out")
    mdim = 0 if experts else _MODEL_DIM.get(name)
    replicated_kv = name in ("wk", "wv") and cfg.n_kv_heads % m != 0
    if replicated_kv or m == 1:
        mdim = None
    cuts = []
    if mdim is not None:
        mdim += off
        whole = shape[mdim]
        if "mix" in path and name in _D_INNER:    # whole SSM heads
            block = model_block(cfg.ssm_heads, m) * cfg.ssm_headdim
        else:
            block = model_block(vocab_padded(cfg) if name in
                                ("tok", "unembed") else whole, m)
        cuts.append((mdim, "model", whole, block))
    if cfg.fsdp and d > 1 and name in _FSDP:
        first = off + (2 if experts and cfg.opt_moe_dispatch
                       and name != "w_out" else 0)
        for i in range(first, len(shape)):
            if i != mdim and shape[i] % d == 0:
                cuts.append((i, "data", shape[i], shape[i] // d))
                break
    sp = cfg.fsdp and m > 1
    return Place(tuple(cuts), sum_model=m > 1 and (
        replicated_kv or name in _SUM_MODEL or (sp and name in _NORMS)))


def tree_places(tree: Any, cfg: ModelConfig, mesh: Tuple[int, int]) -> Any:
    """:func:`leaf_place` of every leaf of a params tree."""
    return tree_map_paths(lambda p, _: leaf_place(p, cfg, mesh), tree)


def take_cuts(t: torch.Tensor, cuts, world) -> torch.Tensor:
    """This rank's part of the whole leaf ``t`` under ``cuts`` (a view)."""
    for dim, axis, whole, block in cuts:
        if t.shape[dim] != whole:
            raise ValueError(f"a leaf of {tuple(t.shape)} is not whole "
                             f"({whole}) along dim {dim}")
        lo, hi = axis_range(whole, block, getattr(world, axis).rank)
        t = t.narrow(dim, lo, hi - lo)
    return t


def gather_cuts(t: torch.Tensor, cuts, world, root: bool = False
                ) -> Optional[torch.Tensor]:
    """The whole leaf from every rank's part ``t`` under ``cuts`` (each rank
    calls it; a block short of ``block`` is padded for the gather).
    ``root``: gathered on the host of rank 0 alone, an axis at a time
    (the ranks at index 0 of the axes gathered so far take part in the
    next); every other rank gets None.  gloo gathers host tensors (it
    gathers no card tensor), NCCL card tensors (it takes no host tensor):
    under NCCL the whole leaf is on rank 0's card."""
    from repro_torch.distributed.comm import all_gather, gather_to_first
    if root:
        t = t.detach()
        if world.backend != "nccl":
            t = t.cpu()
    for dim, axis, whole, block in cuts:
        ax = getattr(world, axis)
        if t is None:
            continue
        if t.shape[dim] < block:
            pad = list(t.shape)
            pad[dim] = block - t.shape[dim]
            t = torch.cat([t, t.new_zeros(pad)], dim)
        t = (gather_to_first(t.contiguous(), dim, ax) if root else
             all_gather(t.contiguous(), dim, ax))
        if t is not None:
            t = t.narrow(dim, 0, whole)
    if root and world.rank != 0:
        return None
    return t


@dataclasses.dataclass(frozen=True)
class Par:
    """A model's view of a world (None on one device): the ``world``, its
    ``model`` and ``data`` axes, ``fsdp`` (the FSDP leaves cut over
    ``data`` and gathered a layer at a time) and ``sp`` (the residual
    stream cut by sequence over ``model`` where it is longer than one
    position: Megatron-style sequence parallelism, the reference's
    ``constrain(x, P(data, model, None))`` under ``cfg.fsdp``)."""

    world: Any
    fsdp: bool
    sp: bool

    @property
    def model(self):
        return self.world.model

    @property
    def data(self):
        return self.world.data

    @staticmethod
    def of(cfg: ModelConfig, world) -> Optional["Par"]:
        if world is None:
            return None
        d, m = world.mesh
        check_model_axis(cfg, m)
        return Par(world, fsdp=cfg.fsdp and d > 1, sp=cfg.fsdp and m > 1)

    def head_range(self, cfg: ModelConfig) -> Tuple[int, int]:
        """This rank's query heads ``[lo, hi)`` (empty on a rank past the
        last block)."""
        m = self.model.size
        return axis_range(cfg.n_heads, model_block(cfg.n_heads, m),
                          self.model.rank)

    def kv_range(self, cfg: ModelConfig) -> Tuple[int, int]:
        """The K/V heads this rank's query heads read, ``[lo, hi)``: its
        cut of them, or where they are replicated the ones its heads read,
        ``[lo // G, (hi - 1) // G + 1)`` for heads ``[lo, hi)``, which may
        straddle groups (empty where the rank has no heads)."""
        kv, m = cfg.n_kv_heads, self.model.size
        if kv % m == 0:
            k = kv // m
            return self.model.rank * k, (self.model.rank + 1) * k
        g = cfg.n_heads // kv
        lo, hi = self.head_range(cfg)
        if lo == hi:
            return lo // g, lo // g
        return lo // g, (hi - 1) // g + 1

    def expert_range(self, cfg: ModelConfig) -> Tuple[int, int]:
        """This rank's experts ``[lo, hi)`` (empty on a rank past the last
        block)."""
        return axis_range(cfg.n_experts, model_block(cfg.n_experts,
                                                     self.model.size),
                          self.model.rank)

    def ssm_head_range(self, cfg: ModelConfig) -> Tuple[int, int]:
        """This rank's SSM heads ``[lo, hi)``; its ``d_inner`` channels are
        theirs, ``[lo * ssm_headdim, hi * ssm_headdim)``."""
        return axis_range(cfg.ssm_heads, model_block(cfg.ssm_heads,
                                                     self.model.size),
                          self.model.rank)

    def kv_replicated(self, cfg: ModelConfig) -> bool:
        return cfg.n_kv_heads % self.model.size != 0
