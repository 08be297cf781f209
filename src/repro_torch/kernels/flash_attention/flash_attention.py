"""Flash attention, forward: the wrapper of the hand-written CUDA kernel.

:func:`flash_attention` computes ``softmax(q kᵀ hd^-½ + mask) v`` for q
``(B, S, H, hd)`` and k, v ``(B, Sk, KV, hd)`` with ``H % KV == 0`` (query
head h reads K/V head ``h // (H // KV)``), causal or full, in q's dtype.
Its kernel, ``csrc/flash_attention.cu``, replaces the TPU kernel ``_kernel``
and its wrapper of the JAX package's ``kernels/flash_attention``; the
design is written out in the source.  The JAX wrapper's ``block_q``,
``block_k`` and ``interpret`` have no counterpart: the tile sizes are the
source's own constants, and S need not divide them.

The kernel has two bodies, and :func:`_route` picks one from the dtype and
the head dim alone (:data:`ROUTES`): bfloat16 goes to the tensor-core body
(``flash_fwd_tc``: TMA loads, ``wgmma`` for both products), float32 to the
CUDA-core body (``flash_fwd_simt``), which keeps float32's 2e-5 tolerance
that the tensor cores' TF32 cannot meet.  Every head dim of
:data:`HEAD_DIMS` has both; no bfloat16 head dim is left on the CUDA-core
body.  The tensor-core body reads q, k and v through TMA, which needs a
16-byte-aligned base and (batch, sequence, head) strides that are
multiples of 16 bytes (:func:`_tma_ready`); an input that has neither is
first copied into a contiguous tensor, which the same kernel then reads.

On CUDA tensors it launches the kernel (built at its first launch by
:mod:`repro_torch.kernels._build`, never at import); on CPU tensors it
returns the plain version (:mod:`.ref`); on ``meta`` tensors (the dry
run) it returns the empty output and computes nothing.  On the card and
on ``meta`` it records the call's work (:func:`work`) for a cost model
(:mod:`repro_torch.kernels.work`).  Inputs of another dtype than
float32 or bfloat16, of mixed devices or dtypes, or of mismatched shapes
raise on either device; on the card a head dim outside :data:`HEAD_DIMS`
raises too.  :data:`LAUNCHES` counts the kernel's launches: in all under
``"flash_attention"``, and per body under ``"flash_attention_tc"`` and
``"flash_attention_simt"``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import work as kernel_work
from repro_torch.kernels._build import load_library

from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)        # the kernel's instantiations
# (dtype, head dim) -> the body that serves it
ROUTES = {(dt, hd): body for dt, body in ((torch.bfloat16, "tc"),
                                          (torch.float32, "simt"))
          for hd in HEAD_DIMS}
_GRID_MAX = 65535                          # CUDA grid y and z
_TC_ROWS = 128                             # query rows per tensor-core CTA

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_tc": 0,
                            "flash_attention_simt": 0}
_FN: Dict[str, object] = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _route(dtype: torch.dtype, hd: int) -> str:
    """The body that serves ``dtype`` at head dim ``hd``: "tc" or "simt".
    Raises for a pair that has none."""
    body = ROUTES.get((dtype, hd))
    if body is None:
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"flash_attention: {dtype}; float32 and "
                             f"bfloat16 are supported")
        raise ValueError(f"flash_attention: head dim {hd} has no kernel "
                         f"instantiation; supported: {HEAD_DIMS}")
    return body


def _launcher(body: str):
    fn = _FN.get(body)
    if fn is None:
        fn = getattr(load_library("flash_attention"),
                     f"flash_attention_{body}_launch")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_longlong), p]
        fn.restype = ctypes.c_int
        _FN[body] = fn
    return fn


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """The (batch, sequence, head) element strides of ``t`` as a kernel
    reads them: a dim of size 1 is never stepped along, so its stride,
    which torch leaves arbitrary, is replaced by the packed one."""
    out, packed = [], t.shape[3]
    for i in (2, 1, 0):
        out.append(t.stride(i) if t.shape[i] > 1 else packed)
        packed = out[-1] * t.shape[i]
    return out[2], out[1], out[0]


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read ``t`` in place: a dense head dim, a 16-byte
    aligned base and (batch, sequence, head) strides of a multiple of 16
    bytes."""
    size = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in _strides(t)))


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
        if t.dtype not in (torch.float32, torch.bfloat16):
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
        body = _route(q.dtype, hd)
        tiles = -(-S // _TC_ROWS) if body == "tc" else 1
        if max(H, B, tiles) > _GRID_MAX:
            raise ValueError(f"flash_attention: H={H}, B={B} and S / "
                             f"{_TC_ROWS} must be at most {_GRID_MAX} (the "
                             f"launch grid)")


def work(q: torch.Tensor, k: torch.Tensor, causal: bool) -> Tuple[int, int]:
    """``(FLOPs, bytes)`` of one call: q.k and p.v, ``2 hd`` each per
    (query, key) pair the mask keeps; q, k and v read once, the output
    written once."""
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    pairs = S * (S + 1) // 2 if causal else S * Sk
    return (4 * B * H * hd * pairs,
            q.element_size() * hd * B * (2 * S * H + 2 * Sk * KV))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,Sk,KV,hd).  Returns (B,S,H,hd) in q's dtype."""
    dev = q.device if isinstance(q, torch.Tensor) else None
    _check(q, k, v, for_kernel=dev is not None and dev.type == "cuda")
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=bool(causal))
    if dev.type == "meta":
        kernel_work.record("flash_attention", *work(q, k, bool(causal)))
        return q.new_empty(q.shape)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if kernel_work.SINKS:
        kernel_work.record("flash_attention", *work(q, k, bool(causal)))
    body = _route(q.dtype, hd)
    if body == "tc":
        q, k, v = (t if _tma_ready(t) else
                   torch.empty(t.shape, dtype=t.dtype, device=dev).copy_(t)
                   for t in (q, k, v))
    else:   # the kernel reads (b, s, h) through strides; hd must be dense
        q, k, v = (t if t.stride(3) == 1 else t.contiguous()
                   for t in (q, k, v))
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in _strides(t)))
    with torch.cuda.device(dev):        # the launcher uses the current device
        err = _launcher(body)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), B, S, Sk, H, KV, hd,
                              int(bool(causal)), strides,
                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention: kernel launch failed with CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{body}"] += 1
    return out
