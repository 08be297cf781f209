"""The port's Mamba-2 block (``models/ssm.py``) against the JAX package's,
on the CPU, at mamba2-2.7b's smoke width (d_model 64, 8 heads of 16, state
16, conv 4).

Weights come from the JAX ``init_mamba`` with the per-head ``A_log``,
``Dp`` and ``dt_bias`` and the per-channel ``norm`` drawn at random (their
init is constant, under which a tiled ``Dp`` or a head-order slip would
not show), carried across with ``lm_params_from_reference``; activations
from numpy with fixed seeds.  Tolerances: float32 ``rtol = atol = 1e-5``
against the JAX functions, but for ``mamba_forward`` over a sequence of a
whole chunk or more, held at ``rtol = atol = 1e-4``: the within-chunk
cumulative decay ``seg`` reaches |seg| ~ 640 over 256 tokens at these
parameters (fp32 ulp 6.1e-5 there), XLA's cumsum (a reduce-window
rewrite) adds in another order than torch's, and the exponents ``seg_q -
seg_t`` of the decays carry that difference (measured: 5.1e-5 on outputs
of magnitude up to 8.2; 2.7e-6 inside a 64-token chunk, |seg| ~ 21).  The
port's decode stepped over a sequence against its own chunked forward
within 2e-3 (the JAX package's ``test_decode_matches_forward`` tolerance:
the two sum in other orders); bfloat16 ``max |d| / max |ref| <= 2e-2``, as
the model tests hold it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jax_ssm

from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_reference
from repro_torch.models import ssm

ARCH = "mamba2-2.7b"
CUMSUM_TOL = 1e-4


def _layer(seed, dtype="float32"):
    """(JAX cfg, JAX params, port cfg, port params) of one mamba block,
    its per-head and per-channel float32 leaves drawn at random."""
    jcfg = jax_get_config(ARCH, smoke=True, dtype=dtype)
    jp, _ = jax_ssm.init_mamba(jax.random.PRNGKey(seed), jcfg)
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(seed)
    H, di = jcfg.ssm_heads, jcfg.d_inner
    jp.update(A_log=rng.normal(0.0, 0.7, H).astype(np.float32),
              Dp=rng.normal(1.0, 0.8, H).astype(np.float32),
              dt_bias=rng.normal(-2.0, 0.8, H).astype(np.float32),
              norm=rng.normal(0.0, 0.3, di).astype(np.float32))
    tp = lm_params_from_reference(jp, device="cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    return jcfg, jp, get_config(ARCH, smoke=True, dtype=dtype), tp


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _h0(cfg, B, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (B, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state))).astype(
            np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("S", [64, 256, 512])
def test_mamba_forward_matches_reference(S, with_h0):
    """Inside one chunk, exactly one chunk, and two chunks (the inter-chunk
    loop carries the state once), from a zero or a given state."""
    jcfg, jp, cfg, tp = _layer(seed=S)
    x = _x(cfg, 2, S, seed=S + 1)
    h0 = _h0(cfg, 2, seed=S + 2) if with_h0 else None
    want, wh = jax_ssm.mamba_forward(
        jp, jnp.asarray(x), jcfg, None if h0 is None else jnp.asarray(h0))
    got, gh = ssm.mamba_forward(
        tp, torch.from_numpy(x), cfg,
        None if h0 is None else torch.from_numpy(h0))
    assert got.shape == (2, S, cfg.d_model)
    assert gh.shape == (2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    tol = 1e-5 if S < ssm.CHUNK else CUMSUM_TOL
    _close(got, want, tol)
    _close(gh, wh, tol)


@pytest.mark.parametrize("S", [64, 512])
def test_decode_steps_match_reference_and_forward(S):
    """``mamba_decode_step`` stepped over S tokens: each step's output and
    state against the JAX step (1e-5); the outputs and the final state
    against the chunked forward of the same sequence (2e-3)."""
    jcfg, jp, cfg, tp = _layer(seed=7)
    B, K = 2, cfg.ssm_conv
    x = _x(cfg, B, S, seed=8)
    jh = jnp.zeros((B, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state))
    jconv = jnp.zeros((B, K - 1, cfg.d_inner + 2 * cfg.ssm_state))
    th, tconv = torch.from_numpy(np.array(jh)), torch.from_numpy(
        np.array(jconv))
    step = jax.jit(lambda p, x, h, c: jax_ssm.mamba_decode_step(p, x, h, c,
                                                                jcfg))
    outs = []
    for t in range(S):
        w, jh, jconv = step(jp, jnp.asarray(x[:, t:t + 1]), jh, jconv)
        g, th, tconv = ssm.mamba_decode_step(
            tp, torch.from_numpy(x[:, t:t + 1]), th, tconv, cfg)
        if t % 37 == 0 or t == S - 1:
            _close(g, w)
            _close(th, jh)
            _close(tconv, jconv)
        outs.append(g[:, 0])
    full, h_last = ssm.mamba_forward(tp, torch.from_numpy(x), cfg)
    _close(torch.stack(outs, 1), full.numpy(), tol=2e-3)
    _close(th, h_last.numpy(), tol=2e-3)


def test_large_decay_stays_finite():
    """A steep per-head decay (``A`` near -150 with ``dt`` near 10) makes
    the intra-chunk exponent overflow above the diagonal; the mask selects
    after the exp, so no ``inf * 0`` reaches the sums."""
    jcfg, jp, cfg, tp = _layer(seed=5)
    tp = dict(tp, A_log=torch.full_like(tp["A_log"], 5.0),
              dt_bias=torch.full_like(tp["dt_bias"], 10.0))
    jp = dict(jp, A_log=jnp.full_like(jp["A_log"], 5.0),
              dt_bias=jnp.full_like(jp["dt_bias"], 10.0))
    x = _x(cfg, 2, 256, seed=6)
    got, gh = ssm.mamba_forward(tp, torch.from_numpy(x), cfg)
    assert torch.isfinite(got).all() and torch.isfinite(gh).all()
    want, _ = jax_ssm.mamba_forward(jp, jnp.asarray(x), jcfg)
    _close(got, want, CUMSUM_TOL)


def test_softplus_is_jax_softplus():
    x = torch.tensor([-50.0, -3.0, 0.0, 2.5, 19.0, 21.0, 40.0, 90.0])
    np.testing.assert_array_equal(
        ssm.softplus(x).numpy(), np.asarray(jax.nn.softplus(
            jnp.asarray(x.numpy()))))


def test_bf16_forward_and_decode_norm_wise():
    jcfg, jp, cfg, tp = _layer(seed=9, dtype="bfloat16")
    x = _x(cfg, 2, 512, seed=10)
    want, wh = jax_ssm.mamba_forward(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    got, gh = ssm.mamba_forward(tp, torch.from_numpy(x).bfloat16(), cfg)
    assert got.dtype == gh.dtype == torch.bfloat16
    for g, w in ((got, want), (gh, wh)):
        w = np.asarray(w, np.float32)
        assert float(np.abs(g.float().numpy() - w).max()
                     / np.abs(w).max()) <= 2e-2


def test_cache_layout_and_chunk_rule():
    cfg = get_config(ARCH, smoke=True)
    c = ssm.init_ssm_cache(cfg, 3, 2, device="cpu")
    jc = jax_ssm.init_ssm_cache(jax_get_config(ARCH, smoke=True), 3, 2)
    assert {k: tuple(v.shape) for k, v in c.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    assert c["conv"].shape[-1] == cfg.d_inner + 2 * cfg.ssm_state
    _, _, _, tp = _layer(seed=0)
    with pytest.raises(ValueError, match="no multiple of the chunk"):
        ssm.mamba_forward(tp, torch.zeros(1, 300, cfg.d_model), cfg)
