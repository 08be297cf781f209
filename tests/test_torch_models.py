"""The port's LM substrate against the JAX package's, at smoke size.

For the SMOKE configs of the ported architectures (granite-20b: gelu and
MQA; deepseek-coder-33b: swiglu; nemotron-4-340b: relu2; h2o-danube-1.8b:
sliding window; dbrx-132b: MoE top-2 of 4 with the matching router;
llama4-maverick: MoE top-1, shared expert, chunked attention) the JAX
``Model.init`` parameters are carried across with
``lm_params_from_reference`` and both packages run on the same numpy
tokens.  Tolerances: float32 elementwise ``rtol = atol = 1e-5``
(``attn_impl`` "pallas" runs the JAX kernel in interpret mode and the
port's plain version); bfloat16 ``max |Δ| / max |ref| <= 2e-2`` over the
logits, since torch and XLA round bf16 products at different places on the
CPU (a few logits of magnitude 4 differ by one bf16 ulp, 0.031).  In
bfloat16 those roundings also move the MoE router's fp32 logits by ~0.01,
which flips a near-tie between two candidate experts (the JAX jitted
forward itself routes such a token otherwise than its own op-by-op
layers), so the MoE configs are held in bfloat16 layer by layer, each
half of a block from the reference's input.
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
from repro.models import transformer as jax_transformer
from repro.models.attention import _plain_attn as jax_plain_attn
from repro.models.attention import blockwise_attn as jax_blockwise_attn

from repro_torch.configs import ARCH_NAMES, PORTED, get_config
from repro_torch.configs.shapes import (SHAPES, ShapeCell, applicable,
                                        make_inputs)
from repro_torch.interop import (lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.attention import _plain_attn, blockwise_attn
from repro_torch.models import transformer
from repro_torch.models.common import tree_size
from repro_torch.models.transformer import vocab_padded

DENSE = ["granite-20b", "deepseek-coder-33b", "nemotron-4-340b",
         "h2o-danube-1.8b"]
MOE = ["dbrx-132b", "llama4-maverick-400b-a17b"]
ARCHS = DENSE + MOE


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
    want, waux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 64, vocab_padded(tm.cfg))
    assert got.dtype == getattr(torch, dtype)
    assert aux["lb_loss"].dtype == torch.float32
    if arch in DENSE:
        assert float(aux["lb_loss"]) == float(waux["lb_loss"]) == 0.0
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(aux["lb_loss"]),
                                   float(waux["lb_loss"]), rtol=1e-5)
    elif arch in MOE:
        _hold_layer_by_layer(jm, jp, tm, tp, toks)
    else:
        assert _rel(got, want) <= 2e-2


def _hold_layer_by_layer(jm, jp, tm, tp, toks):
    """The bf16 MoE forward, layer by layer: from the reference's input to
    each layer, the attention half and (from the reference's FFN input)
    the MoE half within the bf16 norm-wise tolerance, the router's
    assignment bit for bit; then the head from the reference's last
    residual.  The reference's layers run op by op, as ``block_fwd``."""
    from repro.models import attention as jatt
    from repro.models import moe as jmoe
    from repro_torch.models import attention as tatt
    from repro_torch.models import moe as tmoe
    from repro_torch.models.common import rms_norm
    jcfg, cfg = jm.cfg, tm.cfg
    mask = jm._mask_kind()
    S = toks.shape[1]
    jpos = jnp.arange(S, dtype=jnp.int32)
    tpos = torch.arange(S, dtype=torch.int32)

    def port(x):
        return lm_params_from_reference(np.asarray(x), device="cpu")

    x = jax_transformer.embed_tokens(jp["embed"], jnp.asarray(toks), jcfg)
    assert torch.equal(transformer.embed_tokens(
        tp["embed"], torch.from_numpy(toks), cfg), port(x))
    for i in range(cfg.n_layers):
        jl = jax.tree.map(lambda a: a[i], jp["layers"])
        tl = transformer._layer(tp["layers"], i)
        want = x + jatt.attention(
            jl["attn"], jax_common.rms_norm(x, jl["ln1"], jcfg.norm_eps),
            jpos, jcfg, mask_kind=mask)
        xt = port(x)
        got = xt + tatt.attention(
            tl["attn"], rms_norm(xt, tl["ln1"], cfg.norm_eps),
            tpos, cfg, mask_kind=mask)
        assert _rel(got, want) <= 2e-2, f"layer {i}: attention"
        h = jax_common.rms_norm(want, jl["ln2"], jcfg.norm_eps)
        y, jaux = jmoe.moe_ffn(jl["ffn"], h, jcfg)
        yt, taux = tmoe.moe_ffn(tl["ffn"], port(h), cfg)
        assert _rel(yt, y) <= 2e-2, f"layer {i}: moe"
        np.testing.assert_allclose(float(taux["drop_rate"]),
                                   float(jaux["drop_rate"]), atol=1e-6)
        logits = h.reshape(-1, jcfg.d_model).astype(jnp.float32) \
            @ jl["ffn"]["router"]
        C = jmoe.capacity_for(jcfg, logits.shape[0])
        route = (jmoe.route_matching if jcfg.router == "matching"
                 else jmoe.route_topk)
        ja = route(logits, jcfg.top_k, C)[0]
        ta = tmoe._router(cfg)(port(logits), cfg.top_k, C)[0]
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        x = want + y
    want = jax_transformer.lm_head(jp["embed"], x, jcfg)
    assert _rel(transformer.lm_head(tp["embed"], port(x), cfg), want) <= 2e-2


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


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """Teacher-forced decode over a prompt reproduces the forward logits
    (the JAX package's ``test_decode_matches_forward`` tolerance).  The MoE
    configs route by a capacity that depends on the token count, so their
    case, under a capacity no token overflows, is in test_torch_moe.py."""
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
    terms the analytic count leaves out: the final norm ``ln_f`` (d_model)
    and llama4's shared expert (three D x F matrices a layer)."""
    jm, jp, tm, _ = _pair(arch)
    mine = tm.init(0, device="cpu")
    want = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jp)
    got = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                       lm_params_to_reference(mine))
    assert got == want
    size = tree_size(mine)
    assert size == jax_common.tree_size(jp)
    cfg = tm.cfg
    shared = (3 * cfg.n_layers * cfg.d_model * cfg.d_ff
              if cfg.moe_shared_expert else 0)
    assert size == cfg.params_count() + cfg.d_model + shared
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
    for arch in ARCH_NAMES:
        full = get_config(arch)
        assert full.params_count() == jax_get_config(arch).params_count()
        assert full.tdtype == torch.bfloat16


def test_config_fields_match_reference():
    """The two ``ModelConfig``s have the same fields and defaults, and the
    FULL and SMOKE configs of all ten architectures, every one ported,
    equal the JAX ones field for field."""
    mine = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(jax_common.ModelConfig)}
    assert mine == theirs
    assert ARCH_NAMES == JAX_ARCH_NAMES
    assert sorted(PORTED) == sorted(ARCH_NAMES)
    for arch in PORTED:
        for smoke in (False, True):
            assert (dataclasses.asdict(get_config(arch, smoke)) ==
                    dataclasses.asdict(jax_get_config(arch, smoke)))


def test_unported_architectures_and_knobs_raise():
    """Every architecture builds, and an unknown one raises.  Both knobs
    now build and run in every architecture: a forward with
    ``opt_attn_layout`` and ``opt_kv_quant``, then two decode steps on the
    int8 cache (finite logits, int8 codes written) -- except the hybrid,
    whose int8 cache is refused with the reason (the JAX package has none
    that works), and the SSM, which has no KV cache to quantise."""
    for arch in ARCH_NAMES:
        build_model(get_config(arch, smoke=True))
    with pytest.raises(KeyError):
        get_config("gpt-2")
    for arch in ARCH_NAMES:
        cfg = get_config(arch, smoke=True, opt_kv_quant=True,
                         opt_attn_layout=True)
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        batch = make_inputs(cfg, ShapeCell("t", 16, 2, "train"),
                            device="cpu")
        logits, _ = model.forward(params, batch)
        assert torch.isfinite(logits).all(), arch
        if cfg.family == "hybrid":
            with pytest.raises(TypeError, match="hybrid's shared attention"):
                model.init_cache(2, 8, device="cpu")
            continue
        enc_len = batch["enc_frames"].shape[1] if cfg.enc_layers else 0
        cache = model.init_cache(2, 8, enc_len=enc_len, device="cpu")
        assert ("k_scale" in cache) == (cfg.family != "ssm"), arch
        if enc_len:
            cache = model.prefill_encoder(params, cache, batch)
        for t in range(2):
            step_logits, cache = model.decode_step(
                params, cache, batch["tokens"][:, t:t + 1], t)
            assert torch.isfinite(step_logits).all(), arch
        if "k_scale" in cache:
            assert cache["k"].dtype == torch.int8
            assert int(cache["k"][:, :, :2].abs().max()) == 127, arch
    base = get_config("granite-20b", smoke=True)
    for change in (dict(family="hybrid", ssm_state=16, shared_every=2),
                   dict(family="ssm", ssm_state=16), dict(enc_layers=2),
                   dict(frontend="vision"),
                   dict(family="moe", n_experts=4, top_k=1,
                        opt_moe_dispatch=True)):
        build_model(dataclasses.replace(base, **change))


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for arch in ARCH_NAMES:
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
