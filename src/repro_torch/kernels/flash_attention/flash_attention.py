"""Flash attention, forward: the wrapper of the hand-written CUDA kernel.

:func:`flash_attention` computes ``softmax(q kᵀ hd^-½ + mask) v`` for q
``(B, S, H, hd)`` and k, v ``(B, Sk, KV, hd)`` with ``H % KV == 0`` (query
head h reads K/V head ``h // (H // KV)``), causal or full, in q's dtype.
Its kernel, ``csrc/flash_attention.cu``, replaces the TPU kernel ``_kernel``
and its wrapper of the JAX package's ``kernels/flash_attention``; the
design is written out in the source.  The JAX wrapper's ``block_q``,
``block_k`` and ``interpret`` have no counterpart: the tile sizes are the
source's own constants, and S need not divide them.

On CUDA tensors it launches the kernel (built at its first launch by
:mod:`repro_torch.kernels._build`, never at import); on CPU tensors it
returns the plain version (:mod:`.ref`).  Inputs of another dtype than
float32 or bfloat16, of mixed devices or dtypes, or of mismatched shapes
raise on either device; on the card a head dim outside
:data:`HEAD_DIMS` raises too.  :data:`LAUNCHES` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels._build import load_library

from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)        # the kernel's instantiations
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GRID_MAX = 65535                          # CUDA grid y (heads), z (batch)

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
_FN = []


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _launcher():
    if not _FN:
        fn = load_library("flash_attention").flash_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), p]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def _check(q, k, v, *, for_kernel: bool) -> None:
    """Raise on what neither version takes, and, with ``for_kernel``, on
    what the CUDA kernel does not take."""
    named = {"q": q, "k": k, "v": v}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"flash_attention: {name} must be a tensor")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"shape {tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; "
                             f"float32 and bfloat16 are supported")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}; all inputs must share one "
                             f"device")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q "
                             f"{q.dtype}; all inputs must share one dtype")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit (B,S,H,hd), (B,Sk,KV,hd), (B,Sk,KV,hd)")
    KV = k.shape[2]
    if KV < 1 or H % KV != 0:
        raise ValueError(f"flash_attention: {H} query heads do not fold "
                         f"onto {KV} K/V heads (H % KV != 0)")
    if min(B, S, k.shape[1], hd) < 1:
        raise ValueError(f"flash_attention: empty input, q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if for_kernel:
        if hd not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head dim {hd} has no kernel "
                             f"instantiation; supported: {HEAD_DIMS}")
        if H > _GRID_MAX or B > _GRID_MAX:
            raise ValueError(f"flash_attention: H={H} and B={B} must be at "
                             f"most {_GRID_MAX} (the launch grid)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,Sk,KV,hd).  Returns (B,S,H,hd) in q's dtype."""
    dev = q.device if isinstance(q, torch.Tensor) else None
    _check(q, k, v, for_kernel=dev is not None and dev.type == "cuda")
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=bool(causal))
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    # the kernel reads (b, s, h) through strides; the head dim must be dense
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*(
        t.stride(i) for t in (q, k, v, out) for i in range(3)))
    with torch.cuda.device(dev):        # the launcher uses the current device
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), _DTYPE_CODE[q.dtype], B, S, Sk, H,
                          KV, hd, int(bool(causal)), strides,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention: kernel launch failed with CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
