"""The port's optimizer against the JAX package's, on the CPU.

``adamw_update`` on leaves of every shape class the factored branch tells
apart (scalars, vectors, matrices with a unit dim, rank-3 stacks), in both
branches, with and without fp32 masters, float32 and bfloat16 params:
every output leaf within ``rtol = atol = 1e-6`` (float32) or one bf16 ulp
(``2**-7 * max(|a|, |b|)``, bfloat16), the global norm and learning rate
within ``rtol = 1e-6``.  ``compress_grads`` fed the JAX package's own
``jax.random.uniform`` draws: codes and scales bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import compress_grads as jax_compress_grads
from repro.optim import decompress_grads as jax_decompress_grads

from repro_torch.interop import (lm_params_from_reference,
                                 opt_state_from_reference,
                                 opt_state_to_reference)
from repro_torch.models.common import tree_leaves
from repro_torch.optim import (OptConfig, adamw_init, adamw_update,
                               compress_grads, decompress_grads)
from repro_torch.optim import adamw as adamw_mod

SHAPES = {"scalar": (), "one": (1,), "vec": (5,), "row": (1, 7),
          "col": (7, 1), "mat": (6, 9), "stack": (3, 1, 4),
          "stack3": (2, 5, 3)}


def _tree(rng, dtype):
    return {k: rng.standard_normal(s).astype(np.float32).astype(dtype)
            for k, s in SHAPES.items()}


def _close(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if want.dtype != np.float32:
        want = want.astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _check_tree(got, want):
    got_leaves = {k: v for k, v in _items(got)}
    want_leaves = {k: v for k, v in _items(want)}
    assert got_leaves.keys() == want_leaves.keys()
    for k, w in want_leaves.items():
        g = got_leaves[k]
        wa = np.asarray(w)
        if wa.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, k
            gf, wf = g.float().numpy(), wa.astype(np.float32)
            assert np.all(np.abs(gf - wf) <= 2.0 ** -7 * np.maximum(
                np.abs(gf), np.abs(wf)) + 1e-30), k
        else:
            assert str(g.dtype).split(".")[1] == wa.dtype.name, k
            _close(g, wa)


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(factored, master, dtype):
    import ml_dtypes
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    rng = np.random.default_rng(0)
    params = _tree(rng, np_dtype)
    kw = dict(warmup=3, factored=factored, master_fp32=master,
              clip_norm=2.0)
    jcfg, tcfg = JaxOptConfig(**kw), OptConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    specs = jax.tree.map(lambda _: jax.sharding.PartitionSpec(), params)
    jo, _ = jax_adamw_init(jp, specs, jcfg)
    tp = lm_params_from_reference(params, device="cpu")
    to = adamw_init(tp, tcfg)
    _check_tree(to, jax.tree.map(np.asarray, jo))
    for step in range(3):
        grads = _tree(rng, np.float32)
        jp, jo, jm = jax_adamw_update(jp, jax.tree.map(jnp.asarray, grads),
                                      jo, jcfg)
        tp, to, tm = adamw_update(
            tp, lm_params_from_reference(grads, device="cpu"), to, tcfg)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)
        # each step from the JAX package's state: no drift carried over
        _check_tree(tp, jax.tree.map(np.asarray, jp))
        _check_tree(to, jax.tree.map(np.asarray, jo))
        tp = lm_params_from_reference(jax.tree.map(np.asarray, jp),
                                      device="cpu")
        to = opt_state_from_reference(jax.tree.map(np.asarray, jo),
                                      device="cpu")
    assert int(to["step"]) == 3


def test_factored_state_shapes():
    """``_factorable`` as the JAX package has it: rank >= 2 and both last
    dims above 1; otherwise ``vr`` has the leaf's shape and ``vc`` is a
    (1,) dummy."""
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    st = adamw_init(params, OptConfig(factored=True))
    assert set(st) == {"m", "vr", "vc", "step"}
    assert st["vr"]["mat"].shape == (6,) and st["vc"]["mat"].shape == (9,)
    assert st["vr"]["stack3"].shape == (2, 5)
    assert st["vc"]["stack3"].shape == (2, 3)
    for k in ("scalar", "one", "vec", "row", "col", "stack"):
        assert st["vr"][k].shape == SHAPES[k], k
        assert st["vc"][k].shape == (1,), k
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(st["m"]))


@pytest.mark.parametrize("factored", [False, True])
def test_blocks_and_donation_change_no_value(factored, monkeypatch):
    """The update is made in place: it returns the trees it was given.
    Made a block at a time (the CPU block and the card's slab shrunk to 8
    elements, so every leaf above that is cut: flat blocks, slabs of whole
    matrices along the leading dims and blocks of rows), it gives the
    whole-leaf update's values bit for bit."""
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 6, 5), "b": (9, 3), "c": (40,), "d": (3, 1, 7),
              "e": (2, 3, 4, 5)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
    cfg = OptConfig(factored=factored, warmup=1)
    state = adamw_init(params, cfg)

    def copies():
        return ({k: v.clone() for k, v in params.items()},
                {k: ({kk: vv.clone() for kk, vv in v.items()}
                     if isinstance(v, dict) else v.clone())
                 for k, v in state.items()})

    runs = []
    for block in (1 << 40, 8):
        monkeypatch.setattr(adamw_mod, "SLAB", block)
        monkeypatch.setattr(adamw_mod, "CPU_BLOCK", block)
        p, s = copies()
        got_p, got_s, _ = adamw_update(p, grads, s, cfg)
        assert got_p is p and got_s is s
        assert got_p["a"] is p["a"] and got_s["m"]["a"] is s["m"]["a"]
        runs.append((got_p, got_s))
    assert len(adamw_mod._matrices((2, 3, 4, 5))) == 6
    assert len(adamw_mod._blocks(40, 8)) == 5
    (whole_p, whole_s), (blocked_p, blocked_s) = runs
    assert int(blocked_s["step"]) == 1
    for want, got in ((whole_p, blocked_p), (whole_s, blocked_s)):
        for w, g in zip(tree_leaves(want), tree_leaves(got)):
            assert torch.equal(w, g)
    assert not torch.equal(whole_p["a"], params["a"])


def test_update_refuses_a_strided_leaf():
    """A leaf the update writes through a flat view must be contiguous;
    a strided one is refused rather than updated in a copy."""
    params = {"w": torch.zeros(6, 4).t()}
    cfg = OptConfig(warmup=1)
    state = adamw_init(params, cfg)
    with pytest.raises(ValueError, match="strided"):
        adamw_update(params, {"w": torch.ones(4, 6)}, state, cfg)


def test_opt_config_and_schedule_match_reference():
    mine = {f.name: f.default for f in dataclasses.fields(OptConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxOptConfig)}
    assert mine == theirs
    from repro.optim.adamw import _schedule as jax_schedule
    cfg = OptConfig(warmup=7)
    for step in (0, 3, 6, 7, 100):
        got = float(adamw_mod._schedule(cfg, torch.tensor(step,
                                                          dtype=torch.int32)))
        want = float(jax_schedule(JaxOptConfig(warmup=7), jnp.int32(step)))
        assert got == want, step


def test_opt_state_interop_round_trip():
    rng = np.random.default_rng(2)
    params = {"w": torch.from_numpy(rng.standard_normal((3, 4))
                                    .astype(np.float32)).to(torch.bfloat16)}
    for factored in (False, True):
        st = adamw_init(params, OptConfig(factored=factored))
        ref = opt_state_to_reference(st)
        assert ref["step"].dtype == np.int32 and ref["step"].shape == ()
        back = opt_state_from_reference(ref, device="cpu")
        assert back["step"].dtype == torch.int32 and back["step"].ndim == 0
        assert dict(_items(st)).keys() == dict(_items(back)).keys()
        for (_, a), (_, b) in zip(_items(st), _items(back)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_compress_grads_matches_reference_draws():
    rng = np.random.default_rng(3)
    # keys out of order: leaves go in the JAX package's sorted order
    grads = {"b": {"z": np.zeros((4,), np.float32),
                   "c": (1e-3 * rng.standard_normal(11)).astype(np.float32)},
             "a": rng.standard_normal((5, 7)).astype(np.float32)}
    key = jax.random.PRNGKey(4)
    treedef, jout = jax_compress_grads(jax.tree.map(jnp.asarray, grads), key)
    # the JAX function's draws: one key per leaf, split from ``rng``
    keys = jax.random.split(key, len(jax.tree.leaves(grads)))
    draws = [np.asarray(jax.random.uniform(k, g.shape))
             for k, g in zip(keys, jax.tree.leaves(grads))]
    tg = lm_params_from_reference(grads, device="cpu")
    structure, tout = compress_grads(tg, draws=draws)
    assert len(tout) == len(jout)
    for (tq, ts), (jq, js) in zip(tout, jout):
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
    back = decompress_grads(structure, tout)
    want = jax_decompress_grads(treedef, jout)
    for (_, g), w in zip(_items(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compress_grads_with_a_generator():
    g = {"a": torch.linspace(-1, 1, 1001)}
    gen = torch.Generator().manual_seed(0)
    _, [(q1, s1)] = compress_grads(g, gen=gen)
    gen = torch.Generator().manual_seed(0)
    _, [(q2, s2)] = compress_grads(g, gen=gen)
    assert torch.equal(q1, q2) and float(s1) == np.float32(1) / 127
    assert int(q1.abs().max()) == 127
    # stochastic rounding: off by at most one code, unbiased on average
    exact = g["a"] / s1
    assert float((q1.float() - exact).abs().max()) <= 1.0
    assert abs(float((q1.float() - exact).mean())) < 0.05
    with pytest.raises(ValueError, match="exactly one"):
        compress_grads(g)
