"""The two knobs of the LM substrate against the JAX package's, at smoke
size in float32.

``opt_kv_quant`` (the int8 KV cache): teacher-forced decode steps through
both packages from the same weights and tokens; after every
step the cache leaves are held bit for bit (the int8 codes, the bf16
scales, the positions) and the logits within ``rtol = atol = 1e-5``.  The
hybrid refuses the knob (the JAX package raises ``TypeError`` on its first
decode step); the SSM, which has no KV cache, ignores it.

``opt_attn_layout`` (``hflat_blockwise_attn``): the function against the
JAX function in float32 (1e-5) under every mask, and the mirror of
``tests/test_archs.py::test_perf_opt_flags_parity`` (both MoE knobs on
against off, 1e-3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.attention import \
    hflat_blockwise_attn as jax_hflat_blockwise_attn

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCell, make_inputs
from repro_torch.interop import lm_params_from_reference
from repro_torch.models import attention as att
from repro_torch.models import build_model
from repro_torch.models.attention import (blockwise_attn,
                                          hflat_blockwise_attn)

# (arch, first position, steps): danube's ring of 32 wraps past its
# window, llama4's steps cross the end of its 32-position chunk
QUANT_RUNS = [("granite-20b", 0, 8), ("dbrx-132b", 0, 8),
              ("seamless-m4t-medium", 0, 8), ("h2o-danube-1.8b", 28, 8),
              ("llama4-maverick-400b-a17b", 28, 8), ("paligemma-3b", 0, 8)]
MAX_LEN = 64


@functools.lru_cache(maxsize=None)
def _pair(arch, **overrides):
    jm = jax_build_model(jax_get_config(arch, smoke=True, **overrides))
    jp, _ = jm.init(jax.random.PRNGKey(len(arch)))
    tm = build_model(get_config(arch, smoke=True, **overrides))
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _bits(x) -> np.ndarray:
    """The array's bytes as unsigned integers (bf16 compared bit for
    bit)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("arch,first,steps", QUANT_RUNS)
def test_int8_decode_matches_reference(arch, first, steps):
    jm, jp, tm, tp = _pair(arch, opt_kv_quant=True)
    B = 2
    toks = np.random.default_rng(5).integers(
        0, tm.cfg.vocab, (B, steps)).astype(np.int32)
    enc_len = 16 if tm.cfg.enc_layers else 0
    jcache, _ = jm.init_cache(B, MAX_LEN, enc_len=enc_len)
    tcache = tm.init_cache(B, MAX_LEN, enc_len=enc_len, device="cpu")
    assert tcache["k"].dtype == torch.int8
    assert tcache["k_scale"].dtype == torch.bfloat16
    assert tcache["k_scale"].shape == tcache["k"].shape[:-1]
    if enc_len:
        frames = np.random.default_rng(6).standard_normal(
            (B, enc_len, tm.cfg.d_model)).astype(np.float32)
        jcache = jm.prefill_encoder(jp, jcache,
                                    {"enc_frames": jnp.asarray(frames)})
        tcache = tm.prefill_encoder(tp, tcache,
                                    {"enc_frames": torch.from_numpy(frames)})
    jstep = jax.jit(jm.decode_step)
    for t in range(steps):
        pos = first + t
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(pos))
        tl, tcache = tm.decode_step(tp, tcache,
                                    torch.from_numpy(toks[:, t:t + 1]), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5, err_msg=f"logits, step {t}")
        for name in ("k", "v", "k_scale", "v_scale", "idx"):
            np.testing.assert_array_equal(
                _bits(tcache[name]), _bits(jcache[name]),
                err_msg=f"cache {name!r} after step {t}")
    assert tcache["pos"] == first + steps == int(jcache["pos"])
    # the codes use the int8 range and the scales are live
    assert int(tcache["k"].abs().max()) == 127
    assert float(tcache["v_scale"].float().abs().max()) > 0


def test_int8_cache_is_smaller_and_close_to_the_float_cache():
    """The int8 cache takes half the bytes of a bf16 one plus its scales,
    and its decode stays near the float cache's (a sanity bound, not a
    parity tolerance: the int8 rounding is the knob's own error)."""
    _, _, tq, tp = _pair("granite-20b", opt_kv_quant=True)
    _, _, tf, _ = _pair("granite-20b")
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tq.cfg.vocab, (B, S)).astype(np.int32))
    cq = tq.init_cache(B, MAX_LEN, device="cpu")
    cf = tf.init_cache(B, MAX_LEN, device="cpu")
    nbytes = lambda c: sum(c[k].numel() * c[k].element_size()
                           for k in ("k", "v", "k_scale", "v_scale")
                           if k in c)
    bf16_bytes = cf["k"].numel() * 2 * 2
    hd = tq.cfg.hd
    assert nbytes(cq) == bf16_bytes // 2 * (hd + 2) // hd
    for t in range(S):
        lq, cq = tq.decode_step(tp, cq, toks[:, t:t + 1], t)
        lf, cf = tf.decode_step(tp, cf, toks[:, t:t + 1], t)
        gap = float((lq - lf).abs().max() / lf.abs().max())
        assert gap < 0.05, (t, gap)


def test_hybrid_refuses_and_ssm_ignores_the_int8_cache():
    """zamba2: the JAX package's first decode step raises ``TypeError``
    (float K/V into its int8 ``shared_kv``); the port refuses the cache
    with a ``TypeError`` that says so.  mamba2: no KV cache, the knob
    changes nothing (same cache leaves, same logits)."""
    jm, jp, tm, tp = _pair("zamba2-7b", opt_kv_quant=True)
    jcache, _ = jm.init_cache(2, MAX_LEN)
    with pytest.raises(TypeError):
        jm.decode_step(jp, jcache, jnp.zeros((2, 1), jnp.int32),
                       jnp.int32(0))
    with pytest.raises(TypeError, match="hybrid's shared attention block"):
        tm.init_cache(2, MAX_LEN, device="cpu")
    # its forward (training, prefill) does not touch the cache
    toks = torch.zeros((1, 8), dtype=torch.int32)
    assert torch.isfinite(tm.forward(tp, {"tokens": toks})[0]).all()

    _, _, tq, tp = _pair("mamba2-2.7b", opt_kv_quant=True)
    _, _, tf, _ = _pair("mamba2-2.7b")
    cq = tq.init_cache(2, MAX_LEN, device="cpu")
    cf = tf.init_cache(2, MAX_LEN, device="cpu")
    assert sorted(cq) == sorted(cf) and "k_scale" not in cq
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tq.cfg.vocab, (2, 4)).astype(np.int32))
    for t in range(4):
        lq, cq = tq.decode_step(tp, cq, toks[:, t:t + 1], t)
        lf, cf = tf.decode_step(tp, cf, toks[:, t:t + 1], t)
        assert torch.equal(lq, lf)


HFLAT_CASES = [
    # (B, S, H, KV, hd, mask, window, prefix_len, q_block)
    (2, 64, 4, 2, 16, "causal", 0, 0, 16),
    (1, 64, 6, 2, 8, "bidir", 0, 0, 32),
    (2, 48, 4, 1, 16, "swa", 20, 0, 16),
    (1, 64, 4, 4, 16, "chunked", 16, 0, 16),
    (2, 64, 4, 2, 16, "prefix", 0, 24, 32),
]


@pytest.mark.parametrize("case", HFLAT_CASES)
def test_hflat_blockwise_attn_matches_reference(case):
    B, S, H, KV, hd, mask, window, prefix_len, qb = case
    rng = np.random.default_rng(S + H)
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    pos = np.arange(S, dtype=np.int32)
    want = jax_hflat_blockwise_attn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), mask, window, prefix_len, q_block=qb, kv_block=qb)
    args = [torch.from_numpy(a) for a in (q, k, v, pos, pos)]
    got = hflat_blockwise_attn(*args, mask, window, prefix_len, q_block=qb,
                               kv_block=qb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the same function as blockwise_attn, in another loop order
    other = blockwise_attn(*args, mask, window, prefix_len, q_block=qb,
                           kv_block=qb)
    np.testing.assert_allclose(got.numpy(), other.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b",
                                  "granite-20b"])
def test_attn_layout_dispatch_matches_reference(arch, monkeypatch):
    """The forward with ``opt_attn_layout`` through both packages (1e-5),
    and the port's forward with the knob on against off."""
    jm, jp, tm, tp = _pair(arch, opt_attn_layout=True)
    _, _, toff, _ = _pair(arch)
    toks = np.random.default_rng(9).integers(
        0, tm.cfg.vocab, (2, 64)).astype(np.int32)
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    seen = []
    monkeypatch.setattr(att, "hflat_blockwise_attn",
                        lambda *a, **k: seen.append(1) or
                        hflat_blockwise_attn(*a, **k))
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert len(seen) == tm.cfg.n_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    off, _ = toff.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), off.numpy(), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_perf_opt_flags_parity(arch):
    """The mirror of the JAX package's test of the same name: both knobs
    of the MoE configs (``opt_moe_dispatch``, ``opt_attn_layout``) on
    against off, the same weights, within 1e-3."""
    cfg = get_config(arch, smoke=True)
    batch = make_inputs(cfg, ShapeCell("t", 64, 2, "train"), device="cpu")
    outs = {}
    params = None
    for opt in (False, True):
        model = build_model(dataclasses.replace(
            cfg, opt_moe_dispatch=opt, opt_attn_layout=opt))
        params = params or model.init(0, device="cpu")
        logits, _ = model.forward(params, batch)
        outs[opt] = logits.numpy()
    np.testing.assert_allclose(outs[True], outs[False], atol=1e-3, rtol=1e-3)
