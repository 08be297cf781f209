"""Mamba-2 (SSD, arXiv:2405.21060) block: chunked prefill scan and O(1)
decode (the JAX package's ``models/ssm.py``).

The SSD form computes, per head h with scalar decay a_t = exp(dt_t * A_h):

  h_t = a_t * h_{t-1} + dt_t * B_t (x) x_t         (state:  (hd, N))
  y_t = C_t . h_t + D_h * x_t

Prefill runs the chunked algorithm: within chunks of Q tokens the
recurrence is expanded into a masked quadratic form, and the states pass
from chunk to chunk in a loop over the chunks (the JAX function's
``lax.scan``).  Decode is the literal recurrence, one step.  One group
(B and C shared across heads), as in Mamba2 and Zamba2.

Every dtype cast of the JAX function is kept (the intra-chunk weights,
the chunk states and the carried state in the activation dtype, ``dt`` and
the decays in float32), so bfloat16 rounds where the JAX function rounds.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init

CHUNK = 256


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    D, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, K = cfg.ssm_heads, cfg.ssm_conv
    dt, dev = cfg.tdtype, gen.device

    def const(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=dev)

    return {"wz": dense_init(gen, (D, di), dt),
            "wx": dense_init(gen, (D, di), dt),
            "wB": dense_init(gen, (D, N), dt),
            "wC": dense_init(gen, (D, N), dt),
            "wdt": dense_init(gen, (D, H), dt),
            "conv_x": dense_init(gen, (K, di), dt),
            "conv_B": dense_init(gen, (K, N), dt),
            "conv_C": dense_init(gen, (K, N), dt),
            "A_log": const(H, 0.0),
            "Dp": const(H, 1.0),
            "dt_bias": const(H, -2.0),
            "norm": const(di, 0.0),
            "out": dense_init(gen, (di, D), dt)}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, written as JAX defines it: ``logaddexp(x, 0)``
    (``F.softplus`` switches to the identity above its threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (K, C) depthwise causal convolution, the taps
    added in the JAX function's order."""
    K, S = w.shape[0], x.shape[1]
    pads = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pads[:, i: i + S] * w[i]
    return out


def _gated_norm(y, z, scale, eps):
    y = y * F.silu(z)
    var = y.float().square().mean(dim=-1, keepdim=True)
    return (y.float() * torch.rsqrt(var + eps)
            * (1.0 + scale)).to(y.dtype)


def mamba_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence SSD.  x: (B, S, D) -> (B, S, D) and the final state
    (B, H, hd, N).  S must be a multiple of ``CHUNK`` when longer."""
    B, S, D = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    H, hd = cfg.ssm_heads, cfg.ssm_headdim
    Q = min(CHUNK, S)
    if S % Q:
        raise ValueError(f"mamba_forward: S={S} is no multiple of the "
                         f"chunk {Q}")
    nc = S // Q
    dtype = x.dtype

    z = torch.einsum("bsd,de->bse", x, params["wz"])
    xs = _causal_conv(torch.einsum("bsd,de->bse", x, params["wx"]),
                      params["conv_x"])
    Bc = _causal_conv(torch.einsum("bsd,dn->bsn", x, params["wB"]),
                      params["conv_B"])
    Cc = _causal_conv(torch.einsum("bsd,dn->bsn", x, params["wC"]),
                      params["conv_C"])
    xs, Bc, Cc = F.silu(xs), F.silu(Bc), F.silu(Cc)
    dt = softplus(torch.einsum("bsd,dh->bsh", x, params["wdt"]).float()
                  + params["dt_bias"])                         # (B,S,H)
    A = -torch.exp(params["A_log"])                            # (H,)

    xh = xs.reshape(B, nc, Q, H, hd)
    Bh = Bc.reshape(B, nc, Q, N)
    Ch = Cc.reshape(B, nc, Q, N)
    dth = dt.reshape(B, nc, Q, H)
    dA = dth * A                                               # < 0
    seg = torch.cumsum(dA, dim=2)                              # within chunk

    # ---- intra-chunk (quadratic, causal-masked) ---------------------------
    # above the diagonal the exponent is positive and overflows at full
    # width: the mask sets it to -inf before the exp, which gives the JAX
    # function's values (0 there, the same exp below) and a finite
    # gradient, where its mask after the exp gives 0 * inf = NaN in the
    # backward (ROADMAP.md, Queue 3)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(
        causal[None, None, :, :, None],
        seg[:, :, :, None, :] - seg[:, :, None, :, :],
        seg.new_tensor(float("-inf"))))                        # (B,nc,Q,Q,H)
    cb = torch.einsum("bcqn,bctn->bcqt", Ch, Bh)               # (B,nc,Q,Q)
    att = cb[..., None] * decay * dth[:, :, None, :, :]
    del decay
    y_intra = torch.einsum("bcqth,bcthp->bcqhp", att.to(dtype), xh)
    del att

    # ---- chunk states + inter-chunk scan ----------------------------------
    chunk_decay = torch.exp(seg[:, :, -1:, :] - seg)           # (B,nc,Q,H)
    states = torch.einsum("bcth,bctn,bcthp->bchpn",
                          (chunk_decay * dth).to(dtype), Bh.to(dtype), xh)
    total = torch.exp(seg[:, :, -1, :])                        # (B,nc,H)

    h = torch.zeros((B, H, hd, N), dtype=dtype, device=x.device) \
        if h0 is None else h0
    prevs = []
    for c in range(nc):                       # emits h_{c-1} for chunk c
        prevs.append(h)
        h = h * total[:, c, :, None, None].to(h.dtype) + states[:, c]
    h_prevs = torch.stack(prevs, dim=1)                        # (B,nc,H,hd,N)

    inter_decay = torch.exp(seg)                               # (B,nc,Q,H)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Ch.to(dtype), h_prevs) \
        * inter_decay[..., None].to(dtype)

    # jnp.repeat repeats each head's D_h hd times (Tensor.repeat would tile)
    y = (y_intra + y_inter).reshape(B, S, di) \
        + xs * params["Dp"].repeat_interleave(hd)[None, None, :].to(dtype)
    y = _gated_norm(y, z, params["norm"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y, params["out"]), h


def init_ssm_cache(cfg: ModelConfig, n_layers: int, batch: int,
                   dtype: Optional[torch.dtype] = None, *, device
                   ) -> Dict[str, torch.Tensor]:
    """The state ``h`` (L, B, H, hd, N) and the convolution's last K-1
    inputs ``conv`` (L, B, K-1, di + 2N), in the order x, B, C."""
    dtype = dtype or cfg.tdtype
    H, hd, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    K, di = cfg.ssm_conv, cfg.d_inner
    return {"h": torch.zeros((n_layers, batch, H, hd, N), dtype=dtype,
                             device=device),
            "conv": torch.zeros((n_layers, batch, K - 1, di + 2 * N),
                                dtype=dtype, device=device)}


def mamba_decode_step(params, x: torch.Tensor, h: torch.Tensor,
                      conv_state: torch.Tensor, cfg: ModelConfig):
    """One-token recurrence.  x: (B, 1, D); h: (B, H, hd, N); conv_state:
    (B, K-1, di+2N).  Returns (out (B, 1, D), new h, new conv_state)."""
    B = x.shape[0]
    di, N = cfg.d_inner, cfg.ssm_state
    H, hd = cfg.ssm_heads, cfg.ssm_headdim
    z = torch.einsum("bsd,de->bse", x, params["wz"])[:, 0]
    xBC = torch.cat([
        torch.einsum("bsd,de->bse", x, params["wx"]),
        torch.einsum("bsd,dn->bsn", x, params["wB"]),
        torch.einsum("bsd,dn->bsn", x, params["wC"])], -1)[:, 0]
    hist = torch.cat([conv_state, xBC[:, None]], 1)            # (B,K,·)
    w = torch.cat([params["conv_x"], params["conv_B"], params["conv_C"]], 1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist, w))
    conv_state = hist[:, 1:]
    xs = conv_out[:, :di].reshape(B, H, hd)
    Bc = conv_out[:, di:di + N]
    Cc = conv_out[:, di + N:]
    dt = softplus(torch.einsum("bsd,dh->bsh", x, params["wdt"])[:, 0].float()
                  + params["dt_bias"])                          # (B,H)
    A = -torch.exp(params["A_log"])
    da = torch.exp(dt * A)                                      # (B,H)
    h = h * da[..., None, None].to(h.dtype) + torch.einsum(
        "bh,bhp,bn->bhpn", dt.to(x.dtype), xs, Bc)
    y = torch.einsum("bhpn,bn->bhp", h, Cc) \
        + xs * params["Dp"][None, :, None].to(x.dtype)
    y = _gated_norm(y.reshape(B, di), z, params["norm"], cfg.norm_eps)
    out = torch.einsum("be,ed->bd", y, params["out"])[:, None]
    return out, h, conv_state
