"""The port's MoE layer and MoE models against the JAX package's, on the
CPU, at smoke size.

Weights come from the JAX ``init_moe`` / ``Model.init`` and are carried
across with ``lm_params_from_reference``; activations and tokens from
numpy with fixed seeds.  Tolerances: float32 ``rtol = atol = 1e-5``
(``moe_ffn``, the local dispatch and ``aux``; for the layer's output
``atol`` is 1e-5 times the element's summed magnitude, the sum of the
``|p * expert output|`` it adds up (and of ``|shared expert|``), when that
exceeds 1: ``dense_init`` draws the expert weights with ``fan_in = E``, so
the summands reach ~300, and where they cancel to ~0.05 two summation
orders differ by 1.2e-5); the local dispatch against
``moe_ffn`` within 1e-3 (the JAX package's ``test_perf_opt_flags_parity``);
decode against the forward within 2e-3 (its ``test_decode_matches_forward``)
under a capacity that no token can overflow.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe

from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_reference
from repro_torch.models import build_model
from repro_torch.models import moe

MOE = ["dbrx-132b", "llama4-maverick-400b-a17b"]


def _layer(arch, seed, **overrides):
    """(JAX cfg, JAX params, port cfg, port params) of one MoE layer."""
    jcfg = jax_get_config(arch, smoke=True, **overrides)
    jp, _ = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, get_config(arch, smoke=True, **overrides), tp


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _summed_magnitude(params, x, cfg):
    """Per element of the MoE layer's output, the sum of the magnitudes of
    the terms it adds up: ``|p * expert output|`` over the token's choices,
    plus ``|shared expert|``."""
    contrib, _ = moe._routed(params, x, cfg)
    mag = contrib.abs().sum(1).reshape(x.shape)
    if cfg.moe_shared_expert:
        mag = mag + moe._shared_expert(params, x, cfg).abs()
    return mag.numpy()


def _close_summed(got, want, mag, tol):
    """``rtol = tol``; ``atol = tol`` times each element's summed magnitude
    ``mag`` where that exceeds 1, else ``tol``."""
    got, want = np.asarray(got), np.asarray(want)
    bound = tol * np.maximum(1.0, mag) + tol * np.abs(want)
    over = np.abs(got - want) > bound
    assert not over.any(), (
        f"{int(over.sum())} of {over.size} elements off: got {got[over][:4]}"
        f", want {want[over][:4]}, bound {bound[over][:4]}")


@pytest.mark.parametrize("router", ["matching", "topk"])
@pytest.mark.parametrize("dispatch", [False, True], ids=["slots", "local"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, dispatch, router):
    jcfg, jp, cfg, tp = _layer(arch, 1, opt_moe_dispatch=dispatch,
                               router=router, capacity_factor=0.5)
    x = _x(cfg, 2, 48, seed=2)
    want, waux = jax_moe.moe_ffn(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close_summed(got.numpy(), want,
                  _summed_magnitude(tp, torch.from_numpy(x), cfg), 1e-5)
    assert sorted(aux) == sorted(waux) == ["drop_rate", "lb_loss"]
    for key in aux:
        _close(float(aux[key]), float(waux[key]), 1e-5)
    assert float(aux["drop_rate"]) > 0   # capacity below the demand


@pytest.mark.parametrize("arch", MOE)
def test_init_moe_tree_matches_reference(arch):
    jcfg, jp, cfg, _ = _layer(arch, 0)
    mine = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    got = {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in mine.items()}
    assert got == want
    assert mine["router"].dtype == torch.float32


@pytest.mark.parametrize("n_tokens", [1, 7, 64, 1000, 8192])
@pytest.mark.parametrize("arch", MOE)
def test_capacity_matches_reference(arch, n_tokens):
    assert moe.capacity_for(get_config(arch), n_tokens) == \
        jax_moe.capacity_for(jax_get_config(arch), n_tokens)


@pytest.mark.parametrize("arch", MOE)
def test_local_dispatch_matches_moe_ffn(arch):
    """``opt_moe_dispatch`` alone changes no result: the port's model with
    and without it, within the JAX package's parity tolerance."""
    base = build_model(get_config(arch, smoke=True))
    params = base.init(4, device="cpu")
    opt = build_model(get_config(arch, smoke=True, opt_moe_dispatch=True))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, base.cfg.vocab, (2, 64)))
    a, aux_a = base.forward(params, {"tokens": toks})
    b, aux_b = opt.forward(params, {"tokens": toks})
    _close(b.numpy(), a.numpy(), 1e-3)
    _close(float(aux_b["lb_loss"]), float(aux_a["lb_loss"]), 1e-3)


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_forward_without_drops(arch):
    """Teacher-forced decode reproduces the forward within 2e-3 when no
    token can drop: ``capacity_factor = n_experts / top_k`` makes the
    capacity the token count.  Otherwise the capacity depends on the
    token count, which differs between the forward (B*S tokens) and a
    decode step (B tokens), so they route differently in both packages."""
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = build_model(cfg)
    params = model.init(6, device="cpu")
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (B, S)))
    full, aux = model.forward(params, {"tokens": toks})
    cache = model.init_cache(B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    _close(torch.stack(outs, 1).numpy(), full.numpy(), 2e-3)
    assert moe.capacity_for(cfg, B * S) == B * S


def test_llama4_chunked_ring_decode_matches_reference():
    """llama4's chunked attention (SMOKE window 32): a decode of 40 steps
    crosses the chunk boundary, where its ring cache of 32 slots wraps
    and the mask drops the first chunk; step by step against the JAX
    decode, the cache's positions and contents at the end too."""
    arch = "llama4-maverick-400b-a17b"
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    jp, _ = jm.init(jax.random.PRNGKey(8))
    tm = build_model(get_config(arch, smoke=True))
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    B, S = 2, 40
    toks = np.random.default_rng(9).integers(0, tm.cfg.vocab, (B, S)) \
        .astype(np.int32)
    jcache, _ = jm.init_cache(B, S)
    tcache = tm.init_cache(B, S, device="cpu")
    assert tcache["k"].shape[2] == tm.cfg.window == 32
    step = jax.jit(jm.decode_step)
    for t in range(S):
        want, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.int32(t))
        got, tcache = tm.decode_step(tp, tcache,
                                     torch.from_numpy(toks[:, t:t + 1]), t)
        _close(got.numpy(), want, 1e-5)
    idx = tcache["idx"].numpy()
    np.testing.assert_array_equal(idx, np.asarray(jcache["idx"]))
    assert sorted(idx.tolist()) == list(range(8, 40))
    _close(tcache["k"].numpy(), jcache["k"], 1e-5)
