"""The port's LM substrate against the JAX package's, at smoke size.

For the SMOKE configs of the three dense full-attention architectures
(granite-20b: gelu and MQA; deepseek-coder-33b: swiglu; nemotron-4-340b:
relu2) the JAX ``Model.init`` parameters are carried across with
``lm_params_from_reference`` and both packages run on the same numpy
tokens.  Tolerances: float32 elementwise ``rtol = atol = 1e-5``
(``attn_impl`` "pallas" runs the JAX kernel in interpret mode and the
port's plain version); bfloat16 ``max |Δ| / max |ref| <= 2e-2`` over the
logits, since torch and XLA round bf16 products at different places on the
CPU (a few logits of magnitude 4 differ by one bf16 ulp, 0.031).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.configs.shapes import applicable as jax_applicable
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common
from repro.models.attention import _plain_attn as jax_plain_attn
from repro.models.attention import blockwise_attn as jax_blockwise_attn

from repro_torch.configs import ARCH_NAMES, PORTED, get_config
from repro_torch.configs.shapes import (SHAPES, ShapeCell, applicable,
                                        make_inputs)
from repro_torch.interop import (lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.attention import _plain_attn, blockwise_attn
from repro_torch.models.common import tree_size
from repro_torch.models.transformer import vocab_padded

ARCHS = ["granite-20b", "deepseek-coder-33b", "nemotron-4-340b"]


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _pair(arch, **overrides):
    """(JAX model, JAX params, port model, port params) for a SMOKE
    config with ``overrides``, the params carried across."""
    jcfg = jax_get_config(arch, smoke=True, **overrides)
    jm = jax_build_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(len(arch)))
    tm = build_model(get_config(arch, smoke=True, **overrides))
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, impl, dtype):
    jm, jp, tm, tp = _pair(arch, attn_impl=impl, dtype=dtype)
    toks = _tokens(tm.cfg, 2, 64, seed=3)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 64, vocab_padded(tm.cfg))
    assert got.dtype == getattr(torch, dtype)
    assert float(aux["lb_loss"]) == 0.0
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert _rel(got, want) <= 2e-2


def test_forward_last_only_and_blockwise_dispatch_match_reference():
    """Above 2048 positions "xla" attention takes ``blockwise_attn`` in
    both packages; ``last_only`` gives the last position's logits."""
    jm, jp, tm, tp = _pair("granite-20b")
    toks = _tokens(tm.cfg, 1, 3072, seed=4)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, last_only=True)
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                        last_only=True)
    assert got.shape == (1, 1, vocab_padded(tm.cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind,window", [("causal", 0), ("swa", 128),
                                         ("chunked", 128), ("bidir", 0),
                                         ("prefix", 0)])
def test_blockwise_attn_matches_reference(kind, window):
    rng = np.random.default_rng(0)
    B, S, H, KV, hd = 2, 512, 4, 2, 64
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    jpos = jnp.arange(S, dtype=jnp.int32)
    tpos = torch.arange(S, dtype=torch.int32)
    j = [jnp.asarray(a) for a in (q, k, v)]
    t = [torch.from_numpy(a) for a in (q, k, v)]
    want = jax_blockwise_attn(*j, jpos, jpos, kind, window, 64,
                              q_block=128, kv_block=128)
    got = blockwise_attn(*t, tpos, tpos, kind, window, 64, q_block=128,
                         kv_block=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    plain = _plain_attn(*t, tpos, tpos, kind, window, 64)
    np.testing.assert_allclose(
        plain.numpy(), np.asarray(jax_plain_attn(*j, jpos, jpos, kind,
                                                 window, 64)),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """Step by step, the logits and, at the end, the whole cache."""
    jm, jp, tm, tp = _pair(arch)
    B, S = 2, 12
    toks = _tokens(tm.cfg, B, S, seed=5)
    jcache, _ = jm.init_cache(B, S)
    tcache = tm.init_cache(B, S, device="cpu")
    step = jax.jit(jm.decode_step)
    for t in range(S):
        want, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t))
        got, tcache = tm.decode_step(tp, tcache,
                                     torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")
    back = lm_params_to_reference(tcache)
    assert sorted(back) == sorted(jcache)
    assert back["pos"] == int(jcache["pos"]) == S
    np.testing.assert_array_equal(back["idx"], np.asarray(jcache["idx"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(back[name], np.asarray(jcache[name]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced decode over a prompt reproduces the forward logits
    (the JAX package's ``test_decode_matches_forward`` tolerance)."""
    _, _, tm, tp = _pair(arch)
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(tm.cfg, B, S, seed=6))
    full, _ = tm.forward(tp, {"tokens": toks})
    cache = tm.init_cache(B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_sliding_window_ring_cache_matches_reference():
    """A dense config with a sliding window shorter than the decode: the
    ``swa`` mask in the forward and the ring-buffer cache in decode."""
    jm, jp, tm, tp = _pair("granite-20b", attn="swa", window=8)
    toks = _tokens(tm.cfg, 2, 20, seed=7)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jcache, _ = jm.init_cache(2, 20)
    tcache = tm.init_cache(2, 20, device="cpu")
    assert tcache["k"].shape[2] == 8
    step = jax.jit(jm.decode_step)
    for t in range(20):
        w, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                         jnp.int32(t))
        g, tcache = tm.decode_step(tp, tcache,
                                   torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_and_size_match_reference(arch):
    """The port's ``Model.init`` gives the JAX tree (keys, shapes, dtypes);
    ``tree_size`` equals the JAX one, which is ``params_count()`` plus the
    final norm ``ln_f`` (d_model), a term the analytic count leaves out."""
    jm, jp, tm, _ = _pair(arch)
    mine = tm.init(0, device="cpu")
    want = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jp)
    got = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                       lm_params_to_reference(mine))
    assert got == want
    size = tree_size(mine)
    assert size == jax_common.tree_size(jp)
    assert size == tm.cfg.params_count() + tm.cfg.d_model
    assert tm.cfg.params_count() == jm.cfg.params_count()
    again = tm.init(0, device="cpu")
    for a, b in zip(jax.tree.leaves(lm_params_to_reference(mine)),
                    jax.tree.leaves(lm_params_to_reference(again))):
        np.testing.assert_array_equal(a, b)


def test_init_scales_by_fan_in_of_the_first_axis():
    """``dense_init``'s quirk kept: ``fan_in`` is ``shape[0]``, so ``wo``
    of shape (H, hd, D) is drawn with std 1/sqrt(H)."""
    cfg = get_config("granite-20b", smoke=True, n_layers=1, d_model=256,
                     n_heads=4, d_ff=256)
    p = build_model(cfg).init(1, device="cpu")["layers"]["attn"]
    assert abs(float(p["wo"].std()) - 4 ** -0.5) < 0.03
    assert abs(float(p["wq"].std()) - 256 ** -0.5) < 0.01


def test_full_config_sizes():
    assert get_config("granite-20b").params_count() == 20_315_750_400
    for arch in ARCHS:
        full = get_config(arch)
        assert full.params_count() == jax_get_config(arch).params_count()
        assert full.tdtype == torch.bfloat16


def test_config_fields_match_reference():
    """The two ``ModelConfig``s have the same fields and defaults, and the
    ported FULL and SMOKE configs equal the JAX ones field for field."""
    mine = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(jax_common.ModelConfig)}
    assert mine == theirs
    for arch in ARCHS:
        for smoke in (False, True):
            assert (dataclasses.asdict(get_config(arch, smoke)) ==
                    dataclasses.asdict(jax_get_config(arch, smoke)))
    assert ARCH_NAMES == JAX_ARCH_NAMES
    assert sorted(PORTED) == sorted(ARCHS)


def test_unported_architectures_and_knobs_raise():
    for arch in ARCH_NAMES:
        if arch not in PORTED:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                get_config(arch, smoke=True)
    with pytest.raises(KeyError):
        get_config("gpt-2")
    base = get_config("granite-20b", smoke=True)
    for change in (dict(opt_kv_quant=True), dict(opt_attn_layout=True),
                   dict(family="moe", n_experts=4, top_k=1),
                   dict(family="ssm", ssm_state=16), dict(enc_layers=2),
                   dict(frontend="vision")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(dataclasses.replace(base, **change))


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for name in SHAPES:
            assert applicable(cfg, SHAPES[name])[0] == \
                jax_applicable(jcfg, JAX_SHAPES[name])[0]
    cfg = get_config("granite-20b", smoke=True)
    a = make_inputs(cfg, ShapeCell("t", 32, 3, "train"), seed=1,
                    device="cpu")
    b = make_inputs(cfg, ShapeCell("t", 32, 3, "train"), seed=1,
                    device="cpu")
    assert sorted(a) == ["labels", "tokens"]
    assert a["tokens"].shape == (3, 32) and a["tokens"].dtype == torch.int64
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab
    assert all(torch.equal(a[k], b[k]) for k in a)
    d = make_inputs(cfg, ShapeCell("d", 32, 3, "decode"), device="cpu")
    assert d["tokens"].shape == (3, 1)


def test_bf16_params_round_trip_bit_for_bit():
    jm, jp, _, tp = _pair("granite-20b", dtype="bfloat16")
    assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["layers"]["ln1"].dtype == torch.float32
    back = lm_params_to_reference(tp)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                    jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
