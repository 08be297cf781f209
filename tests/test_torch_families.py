"""The SSM, hybrid, encoder-decoder and vision-prefix families of the port
against the JAX package's, on the CPU, at smoke size.

mamba2-2.7b (SSM), zamba2-7b (mamba blocks and one shared attention block
every second layer, sliding window 32), seamless-m4t-medium (encoder and
decoder with cross-attention) and paligemma-3b (patch embeddings through
``vproj`` before the tokens, the prefix-LM mask).  The JAX ``Model.init``
parameters, with every norm scale (``ln*``) and every per-head SSM leaf
(``A_log``, ``Dp``, ``dt_bias``, ``norm``) drawn at random, are carried
across with ``lm_params_from_reference``, and both packages run on the
same numpy tokens, patch embeddings and frames.  Tolerances: float32
``rtol = atol = 1e-5`` (``attn_impl="pallas"`` runs the JAX kernel in
interpret mode and the port's plain version); bfloat16 ``max |d| / max
|ref| <= 2e-2`` over the logits, as ``tests/test_torch_models.py`` holds
the dense family; decode against the port's own forward within 2e-3 (the
JAX package's ``test_decode_matches_forward`` tolerance).  The forwards of
the SSM and the hybrid are held in float32 at ``rtol = atol = 1e-4``, the
bound of ``tests/test_torch_ssm.py`` for the chunked SSD: XLA's cumsum adds
the within-chunk decays in another order than torch's, and at these
per-head parameters ``|seg|`` reaches the hundreds, where an fp32 ulp is
~3e-5 (measured: 1.7e-5 on zamba2's logits).  They are held in bfloat16
block by block, each block from the
reference's input (as the MoE family is): XLA's bfloat16 sigmoid on the
CPU is not torch's (one ulp apart in a third of its values), a mamba block
takes four of them a channel, and over the layers the roundings compound
past the whole-model bound (mamba2 2.1e-2, zamba2 4.2e-2; one block
6.2e-3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import ShapeCell as JaxShapeCell
from repro.configs.shapes import input_specs as jax_input_specs
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCell, input_specs, make_inputs
from repro_torch.interop import (lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.models import attention as att
from repro_torch.models import build_model
from repro_torch.models.common import tree_size
from repro_torch.models.transformer import vocab_padded

SSD_TOL = 1e-4
FAMILIES = ["mamba2-2.7b", "zamba2-7b", "seamless-m4t-medium",
            "paligemma-3b"]
_RANDOM = {"ln1": (0.0, 0.3), "ln2": (0.0, 0.3), "lnx": (0.0, 0.3),
           "ln_f": (0.0, 0.3), "A_log": (0.0, 0.7), "Dp": (1.0, 0.8),
           "dt_bias": (-2.0, 0.8), "norm": (0.0, 0.3)}


def _randomized(tree, rng):
    """The tree with every leaf named in ``_RANDOM`` (norm scales and the
    SSM's per-head leaves, float32) drawn from its normal."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomized(v, rng)
        elif k in _RANDOM:
            out[k] = rng.normal(*_RANDOM[k], v.shape).astype(np.float32)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _pair(arch, **overrides):
    """(JAX model, JAX params, port model, port params) for a SMOKE
    config with ``overrides``, the params carried across."""
    jm = jax_build_model(jax_get_config(arch, smoke=True, **overrides))
    jp, _ = jm.init(jax.random.PRNGKey(len(arch)))
    jp = _randomized(jax.tree.map(np.asarray, jp),
                     np.random.default_rng(len(arch)))
    tm = build_model(get_config(arch, smoke=True, **overrides))
    tp = lm_params_from_reference(jp, device="cpu")
    return jm, jax.tree.map(jnp.asarray, jp), tm, tp


def _batch(cfg, B, S, seed, enc_len=24):
    """numpy inputs: S tokens, the vision prefix's patch embeddings, the
    enc-dec's ``enc_len`` frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["frontend"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        batch["enc_frames"] = rng.standard_normal(
            (B, enc_len, cfg.d_model)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(arch, impl, dtype):
    jm, jp, tm, tp = _pair(arch, attn_impl=impl, dtype=dtype)
    batch = _batch(tm.cfg, 2, 64, seed=3)
    want, waux = jm.forward(jp, _jax(batch))
    got, aux = tm.forward(tp, _torch(batch))
    assert got.shape == (2, 64, vocab_padded(tm.cfg))
    assert got.dtype == getattr(torch, dtype)
    assert float(aux["lb_loss"]) == float(waux["lb_loss"]) == 0.0
    ssd = tm.cfg.family in ("ssm", "hybrid")
    if dtype == "float32":
        tol = SSD_TOL if ssd else 1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)
    elif ssd:
        _hold_block_by_block(jm, jp, tm, tp, batch["tokens"])
    else:
        assert _rel(got, want) <= 2e-2


def _hold_block_by_block(jm, jp, tm, tp, toks):
    """The bf16 SSM / hybrid forward, block by block: each mamba block
    (and the hybrid's shared block after every ``shared_every``-th) from
    the reference's input to it, within the bf16 norm-wise bound; then the
    head from the reference's last residual.  The reference's blocks are
    jitted, as its forward's scan compiles them."""
    from repro.models import transformer as jax_transformer
    from repro_torch.models import transformer
    jcfg, cfg = jm.cfg, tm.cfg
    S = toks.shape[1]
    jpos = jnp.arange(S, dtype=jnp.int32)
    tpos = torch.arange(S, dtype=torch.int32)
    block = jax.jit(jax_transformer.block_fwd,
                    static_argnames=("cfg", "kind", "mask_kind"))

    def port(x):
        return lm_params_from_reference(np.asarray(x), device="cpu")

    def held(jparams, tparams, x, kind, mask, what):
        want, _ = block(jparams, x, jpos, cfg=jcfg, kind=kind,
                        mask_kind=mask)
        got, _ = transformer.block_fwd(tparams, port(x), tpos, cfg, kind,
                                       mask)
        assert _rel(got, want) <= 2e-2, what
        return want

    x = jax_transformer.embed_tokens(jp["embed"], jnp.asarray(toks), jcfg)
    for i in range(cfg.n_layers):
        x = held(jax.tree.map(lambda a: a[i], jp["layers"]),
                 transformer._layer(tp["layers"], i), x, "mamba", "causal",
                 f"layer {i}")
        if cfg.shared_every and i % cfg.shared_every == cfg.shared_every - 1:
            x = held(jp["shared"], tp["shared"], x, "attn", "swa",
                     f"shared block after layer {i}")
    want = jax_transformer.lm_head(jp["embed"], x, jcfg)
    assert _rel(transformer.lm_head(tp["embed"], port(x), cfg), want) <= 2e-2


@pytest.mark.parametrize("arch,S,enc_len", [
    ("paligemma-3b", 3072, 0), ("seamless-m4t-medium", 64, 3072),
    ("zamba2-7b", 3072, 0)])
def test_blockwise_dispatch_matches_reference(arch, S, enc_len):
    """Above 2048 positions both packages take ``blockwise_attn``: the
    prefix mask over patches and text (paligemma; S counts the patches),
    the cross-attention over 3072 frames (seamless, key positions
    ``kv_pos``), the sliding window of the shared block (zamba2)."""
    jm, jp, tm, tp = _pair(arch)
    prefix = tm.cfg.frontend_len if tm.cfg.frontend == "vision" else 0
    batch = _batch(tm.cfg, 1, S - prefix, seed=4, enc_len=enc_len)
    want, _ = jm.forward(jp, _jax(batch), last_only=True)
    seen = []
    real = att.blockwise_attn

    def spy(*a, **kw):
        seen.append(a[5])
        return real(*a, **kw)
    att.blockwise_attn = spy
    try:
        got, _ = tm.forward(tp, _torch(batch), last_only=True)
    finally:
        att.blockwise_attn = real
    want_kinds = {"paligemma-3b": {"prefix"}, "zamba2-7b": {"swa"},
                  "seamless-m4t-medium": {"bidir"}}[arch]
    assert set(seen) == want_kinds and seen
    tol = SSD_TOL if tm.cfg.family == "hybrid" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_flash_kernel_takes_only_causal_and_full_self_attention(arch):
    """Under ``attn_impl="pallas"`` the kernel runs seamless's encoder
    (full) and decoder (causal) self-attention, once a layer each, and
    nothing else: not the cross-attention, not the prefix mask, not the
    hybrid's sliding window; the SSM has no attention."""
    jm, jp, tm, tp = _pair(arch, attn_impl="pallas")
    calls = []
    real = att.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append(causal)
        return real(q, k, v, causal=causal)
    att.flash_attention = spy
    try:
        tm.forward(tp, _torch(_batch(tm.cfg, 2, 32, seed=5)))
    finally:
        att.flash_attention = real
    cfg = tm.cfg
    want = ([False] * cfg.enc_layers + [True] * cfg.n_layers
            if cfg.enc_layers else [])
    assert calls == want


def _decode_both(jm, jp, tm, tp, batch, steps):
    """Teacher-forced decode of ``steps`` tokens in both packages (the
    encoder run first for enc-dec); returns the two final caches after
    checking each step's logits."""
    toks = batch["tokens"]
    B = toks.shape[0]
    enc_len = batch["enc_frames"].shape[1] if tm.cfg.enc_layers else 0
    jcache, _ = jm.init_cache(B, steps, enc_len=enc_len)
    tcache = tm.init_cache(B, steps, enc_len=enc_len, device="cpu")
    if tm.cfg.enc_layers:
        frames = {"enc_frames": batch["enc_frames"]}
        jcache = jm.prefill_encoder(jp, jcache, _jax(frames))
        tcache = tm.prefill_encoder(tp, tcache, _torch(frames))
    step = jax.jit(jm.decode_step)
    for t in range(steps):
        want, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t))
        got, tcache = tm.decode_step(tp, tcache,
                                     torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")
    return jcache, tcache


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_matches_reference(arch):
    """Step by step, the logits and, at the end, the whole cache leaf for
    leaf (the SSM state and convolution window; zamba2's shared KV slices
    past its window of 32, one slice per invocation; seamless's
    cross-attention K/V from ``prefill_encoder``)."""
    jm, jp, tm, tp = _pair(arch)
    S = 40
    jcache, tcache = _decode_both(jm, jp, tm, tp, _batch(tm.cfg, 2, S, 6),
                                  S)
    back = lm_params_to_reference(tcache)
    want = jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    assert back["pos"] == int(want["pos"]) == S
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    if arch == "zamba2-7b":
        kv = back["shared_kv"]
        assert kv["k"].shape[:3] == (2, 2, tm.cfg.window)
        assert sorted(kv["idx"].tolist()) == list(range(S - 32, S))
        assert not np.allclose(kv["k"][0], kv["k"][1])


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """Teacher-forced decode over a prompt reproduces the forward logits
    (zamba2 past its window; seamless over one set of frames; paligemma
    without its image, whose decode, as the JAX package's, takes tokens
    only)."""
    _, _, tm, tp = _pair(arch)
    cfg = tm.cfg
    B, S = 2, 40
    batch = _torch(_batch(cfg, B, S, seed=7))
    if cfg.frontend == "vision":
        batch.pop("frontend")
        tm = build_model(dataclasses.replace(cfg, frontend=""))
    full, _ = tm.forward(tp, batch)
    enc_len = batch["enc_frames"].shape[1] if cfg.enc_layers else 0
    cache = tm.init_cache(B, S, enc_len=enc_len, device="cpu")
    if cfg.enc_layers:
        cache = tm.prefill_encoder(tp, cache, batch)
    outs = []
    for t in range(S):
        lg, cache = tm.decode_step(tp, cache, batch["tokens"][:, t:t + 1], t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_tree_and_size_match_reference(arch):
    """``Model.init`` gives the JAX tree (keys, shapes, dtypes: ``mix``
    without ``ln2``, ``shared``, ``enc``, ``xattn``/``lnx``, ``vproj``);
    ``tree_size`` equals the JAX one; the same seed gives the same
    weights."""
    jm, _, tm, _ = _pair(arch)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    mine = tm.init(0, device="cpu")
    want = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jp)
    got = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                       lm_params_to_reference(mine))
    assert got == want
    assert tree_size(mine) == jax_common.tree_size(jp)
    assert tm.cfg.params_count() == jm.cfg.params_count()
    again = tm.init(0, device="cpu")
    for a, b in zip(jax.tree.leaves(lm_params_to_reference(mine)),
                    jax.tree.leaves(lm_params_to_reference(again))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_input_specs_match_reference(arch, kind):
    """The inputs of a cell, shapes and dtypes, as the JAX package's
    ``input_specs`` gives them (the vision prefix takes ``frontend_len``
    of the positions; enc-dec frames ``max(frontend_len, S // 4)``);
    ``make_inputs`` draws them from its seed."""
    cfg = get_config(arch, smoke=True, dtype="bfloat16")
    jcfg = jax_get_config(arch, smoke=True, dtype="bfloat16")
    S, B = 96, 3
    mine = input_specs(cfg, ShapeCell("t", S, B, kind))
    theirs = jax_input_specs(jcfg, JaxShapeCell("t", S, B, kind))
    assert list(mine) == list(theirs)
    for name, (shape, dtype) in mine.items():
        assert shape == theirs[name].shape, name
        want = "int64" if theirs[name].dtype == jnp.int32 else \
            str(theirs[name].dtype)
        assert str(dtype).replace("torch.", "") == want, name
    a = make_inputs(cfg, ShapeCell("t", S, B, kind), seed=1, device="cpu")
    b = make_inputs(cfg, ShapeCell("t", S, B, kind), seed=1, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(a["tokens"].max()) < cfg.vocab
    for name, (shape, dtype) in mine.items():
        assert tuple(a[name].shape) == shape and a[name].dtype == dtype
