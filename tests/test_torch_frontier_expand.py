"""The port's frontier sweeps against the JAX package's.

On CPU tensors the port's ``frontier_expand_fused``, ``frontier_expand``
(legacy proposals) and ``frontier_expand_pull`` (winners over the CSC
mirror) are their plain PyTorch versions; each must equal the JAX Pallas
kernel run in interpret mode and the JAX oracle, bit for bit, for the WR
and the plain body, over several BFS levels of real probe states (the
states the JAX solver itself reaches).  The CUDA kernels are held against
the same plain versions in ``tests/test_torch_gpu.py``, which runs only
where there is a card.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cheap_matching_jax
from repro.graphs import random_bipartite
from repro.kernels.frontier_expand import (
    frontier_expand as jax_frontier_expand,
    frontier_expand_fused as jax_fused,
    frontier_expand_fused_ref as jax_fused_ref,
    frontier_expand_pull as jax_pull,
    frontier_expand_pull_ref as jax_pull_ref,
    frontier_expand_ref as jax_prop_ref)
from repro.matching import DeviceCSR
from repro.matching.solve import _apply_winner as jax_apply_winner
from repro.matching.solve import level0_state as jax_level0_state

from repro_torch.kernels.frontier_expand import (LAUNCHES,
                                                 frontier_bits,
                                                 frontier_bits_ref,
                                                 frontier_expand,
                                                 frontier_expand_fused,
                                                 frontier_expand_pull,
                                                 frontier_expand_ref,
                                                 reset_launches)
from repro_torch.matching import TorchCSR

# the module, not the function the package exports under the same name
jax_kernels = importlib.import_module(
    "repro.kernels.frontier_expand.frontier_expand")

# the shapes of the JAX package's own fused-kernel test
SHAPES = [
    (256, 256, 3.0, 1024, 256),
    (500, 700, 4.0, 3000, 512),      # pad not a multiple of the tile
    (300, 200, 5.0, 2048, 999),      # tile not a divisor of anything nice
    (64, 64, 2.0, 128, 4096),        # tile bigger than the edge array
]


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.int32))


def _probe_levels(g, wr, max_levels=6):
    """Yield (level, bfs, root, rmatch) for the first levels of the first
    BFS phase from the cheap warm start, advanced by the JAX solver."""
    cm, rm = cheap_matching_jax(g)
    cmj = jnp.concatenate([jnp.asarray(cm), jnp.array([-3], jnp.int32)])
    rmj = jnp.concatenate([jnp.asarray(rm), jnp.array([-3], jnp.int32)])
    bfs, root = jax_level0_state(cmj)
    pred = jnp.full(g.nr + 1, g.nc, jnp.int32)
    for level in range(2, 2 + max_levels):
        yield level, bfs, root, rmj
        win = jax_fused_ref(jnp.asarray(g.ecol), jnp.asarray(g.cadj), bfs,
                            root if wr else None, rmj, jnp.int32(level))
        bfs, root, pred, rmj, ins, _ = jax_apply_winner(
            win, bfs, root, pred, rmj, jnp.int32(level), wr=wr,
            wr_exact=False)
        if not bool(ins):
            return


@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
@pytest.mark.parametrize("nc,nr,deg,pad,blk", SHAPES)
def test_fused_equals_jax_kernel_interpret(nc, nr, deg, pad, blk, wr):
    g = random_bipartite(nc, nr, deg, seed=nc + nr, pad_to=pad)
    ecol, cadj = jnp.asarray(g.ecol), jnp.asarray(g.cadj)
    te, tc = _t(g.ecol), _t(g.cadj)
    reset_launches()
    n_levels = 0
    for level, bfs, root, rm in _probe_levels(g, wr):
        rt = root if wr else None
        want = np.asarray(jax_fused(ecol, cadj, bfs, rt, rm, level,
                                    block_edges=blk, interpret=True))
        ref = np.asarray(jax_fused_ref(ecol, cadj, bfs, rt, rm,
                                       jnp.int32(level)))
        np.testing.assert_array_equal(want, ref)
        got = frontier_expand_fused(te, tc, _t(bfs), _t(root) if wr else None,
                                    _t(rm), level)
        assert got.dtype == torch.int32 and got.shape == (nr + 1,)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"level {level}")
        # the per-edge proposals of the plain version, too
        prop = frontier_expand_ref(te, tc, _t(bfs),
                                   _t(root) if wr else None, _t(rm), level)
        np.testing.assert_array_equal(
            prop.numpy(),
            np.asarray(jax_frontier_expand(ecol, cadj, bfs, rt, rm, level,
                                           block_edges=blk,
                                           interpret=True)))
        n_levels += 1
    assert n_levels >= 2
    # the CPU path is the plain version: no kernel launch counted
    assert sum(LAUNCHES.values()) == 0


@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
@pytest.mark.parametrize("nc,nr,deg,pad,blk", SHAPES)
def test_legacy_and_pull_equal_jax_kernels_interpret(nc, nr, deg, pad, blk,
                                                     wr):
    """The legacy proposals and the pull winners equal the JAX kernels in
    interpret mode and the JAX oracles at every probe level; the pull
    winners also equal the push winners on the same state."""
    g = random_bipartite(nc, nr, deg, seed=nc + 3 * nr, pad_to=pad)
    d = DeviceCSR.from_host(g).with_csc()
    t = TorchCSR.from_host(g, device="cpu").with_csc()
    reset_launches()
    n_levels = 0
    for level, bfs, root, rm in _probe_levels(g, wr):
        rt = root if wr else None
        st = (_t(bfs), _t(root) if wr else None, _t(rm), level)
        prop = frontier_expand(t.ecol, t.cadj, *st)
        assert prop.dtype == torch.int32 and prop.shape == (t.nnz_pad,)
        want = np.asarray(jax_frontier_expand(d.ecol, d.cadj, bfs, rt, rm,
                                              level, block_edges=blk,
                                              interpret=True))
        np.testing.assert_array_equal(prop.numpy(), want,
                                      err_msg=f"proposals level {level}")
        np.testing.assert_array_equal(
            want, np.asarray(jax_prop_ref(d.ecol, d.cadj, bfs, rt, rm,
                                          jnp.int32(level))))
        pull = frontier_expand_pull(t.radj, t.erow, *st)
        assert pull.dtype == torch.int32 and pull.shape == (nr + 1,)
        want = np.asarray(jax_pull(d.radj, d.erow, bfs, rt, rm, level,
                                   block_edges=blk, interpret=True))
        np.testing.assert_array_equal(pull.numpy(), want,
                                      err_msg=f"pull level {level}")
        np.testing.assert_array_equal(
            want, np.asarray(jax_pull_ref(d.radj, d.erow, bfs, rt, rm,
                                          jnp.int32(level))))
        push = frontier_expand_fused(t.ecol, t.cadj, *st)
        np.testing.assert_array_equal(pull.numpy(), push.numpy())
        n_levels += 1
    assert n_levels >= 2
    assert sum(LAUNCHES.values()) == 0


def test_sentinel_slot_sealed_and_unreached_rows_iinf():
    """Inputs no solver state would reach: every edge active, padding
    edges included.  The contract still holds: slot nr is IINF."""
    g = random_bipartite(50, 40, 3.0, seed=3, pad_to=512)
    bfs = torch.full((g.nc + 1,), 2, dtype=torch.int32)      # all at level 2
    rm = torch.full((g.nr + 1,), -1, dtype=torch.int32)
    root = torch.arange(g.nc + 1, dtype=torch.int32)
    for rt in (root, None):
        win = frontier_expand_fused(_t(g.ecol), _t(g.cadj), bfs, rt, rm, 2)
        assert int(win[-1]) == 2**30
        want = jax_fused_ref(jnp.asarray(g.ecol), jnp.asarray(g.cadj),
                             jnp.asarray(bfs.numpy()),
                             None if rt is None else jnp.asarray(rt.numpy()),
                             jnp.asarray(rm.numpy()), jnp.int32(2))
        np.testing.assert_array_equal(win.numpy(), np.asarray(want))


def _winners_oracle(ecol, cadj, bfs, root, rmatch, level):
    """Numpy, one edge at a time: the contract, with out-of-range edge
    slots and roots skipped."""
    nc, nr = len(bfs) - 1, len(rmatch) - 1
    win = np.full(nr + 1, 2**30, np.int64)
    for c, r in zip(ecol.tolist(), cadj.tolist()):
        if not (0 <= c <= nc and 0 <= r < nr) or bfs[c] != level:
            continue
        if root is not None and not (0 <= root[c] <= nc
                                     and bfs[root[c]] >= 1):
            continue
        cm = rmatch[r]
        if cm == -1 or (cm >= 0 and bfs[min(cm, nc)] == 1):
            win[r] = min(win[r], c)
    return win


def _malformed_inputs():
    """A graph with out-of-range columns and rows in its edge slots, NEG
    levels, roots from -3 to nc + 3 and a matching state: (g, ecol, cadj,
    bfs, root, rmatch) as numpy arrays."""
    rng = np.random.default_rng(11)
    g = random_bipartite(60, 50, 4.0, seed=5, pad_to=400)
    ecol, cadj = g.ecol.copy(), g.cadj.copy()
    bad = rng.choice(g.nnz, 40, replace=False)
    ecol[bad[:10]] = rng.integers(-50, 0, 10)
    ecol[bad[10:20]] = rng.integers(g.nc + 1, g.nc + 50, 10)
    cadj[bad[20:30]] = rng.integers(-50, 0, 10)
    cadj[bad[30:]] = rng.integers(g.nr + 1, g.nr + 50, 10)
    bfs = rng.choice(np.array([1, 2, 2, 2, -2**30], np.int32), g.nc + 1)
    root = rng.integers(-3, g.nc + 4, g.nc + 1).astype(np.int32)
    rmatch = rng.choice(np.array([-1, -3, 0, 7, 30, g.nc], np.int32),
                        g.nr + 1)
    return g, ecol, cadj, bfs, root, rmatch


@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
def test_out_of_range_edge_slots_propose_nothing(wr):
    """Edge slots with a column outside [0, nc] or a row outside [0, nr),
    and columns whose root is outside [0, nc], are skipped, as the CUDA
    kernel skips them; nothing raises and no other row changes."""
    g, ecol, cadj, bfs, root, rmatch = _malformed_inputs()
    rt = root if wr else None
    args = (_t(ecol), _t(cadj), _t(bfs), _t(rt) if wr else None,
            _t(rmatch), 2)
    want = _winners_oracle(ecol, cadj, bfs, rt, rmatch, 2)
    np.testing.assert_array_equal(frontier_expand_fused(*args).numpy(), want)
    np.testing.assert_array_equal(frontier_expand_pull(*args).numpy(), want)
    assert (want < 2**30).sum() > 5          # the test proposes something
    # the proposals: the same skips, and the sentinel row nr is a row
    prop = frontier_expand(*args).numpy()
    for e, (c, r) in enumerate(zip(ecol.tolist(), cadj.tolist())):
        ok = (0 <= c <= g.nc and 0 <= r <= g.nr and bfs[c] == 2
              and (rt is None or (0 <= rt[c] <= g.nc and bfs[rt[c]] >= 1))
              and (rmatch[r] == -1 or (rmatch[r] >= 0 and
                                       bfs[min(rmatch[r], g.nc)] == 1)))
        assert prop[e] == (c if ok else 2**30), e


def test_wrapper_rejects_bad_inputs():
    g = random_bipartite(20, 20, 2.0, seed=1)
    e, c = _t(g.ecol), _t(g.cadj)
    bfs = torch.full((21,), 2, dtype=torch.int32)
    rm = torch.full((21,), -1, dtype=torch.int32)
    for sweep in (frontier_expand_fused, frontier_expand,
                  frontier_expand_pull):
        with pytest.raises(ValueError, match="int32"):
            sweep(e.long(), c, bfs, None, rm, 2)
        with pytest.raises(ValueError, match="contiguous"):
            sweep(e, c, torch.stack([bfs, bfs], 1)[:, 0], None, rm, 2)
        with pytest.raises(ValueError, match="differ"):
            sweep(e, c[:-1], bfs, None, rm, 2)
        with pytest.raises(ValueError, match="differ"):
            sweep(e, c, bfs, bfs[:-1], rm, 2)
        with pytest.raises(TypeError, match="level"):
            sweep(e, c, bfs, None, rm, torch.tensor(2))
        with pytest.raises(TypeError, match="level"):
            sweep(e, c, bfs, None, rm, 2**31)
        with pytest.raises(ValueError, match="device"):
            sweep(e.to("meta"), c.to("meta"), bfs.to("meta"), None,
                  rm.to("meta"), 2)


def _jax_column_half(bfs, root, level):
    """The column half of the JAX package's ``_proposals`` for every column
    c in [0, nc]: each column as the one edge (c, 0), row 0 free, so the
    row half holds everywhere."""
    nc = len(bfs) - 1
    active = jax_kernels._proposals(
        jnp.int32(level), jnp.arange(nc + 1, dtype=jnp.int32),
        jnp.zeros(nc + 1, jnp.int32), jnp.asarray(bfs),
        None if root is None else jnp.asarray(root),
        jnp.array([-1], jnp.int32))
    return np.asarray(active)


def _unpack(words, nc):
    """Bit ``c & 31`` of word ``c >> 5`` for c in [0, nc], and the bits
    past column nc (which must be 0)."""
    assert words.dtype == torch.int32 and words.shape == ((nc + 32) // 32,)
    bits = np.unpackbits(words.numpy().view(np.uint8), bitorder="little")
    return bits[:nc + 1].astype(bool), bits[nc + 1:]


@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
@pytest.mark.parametrize("nc,nr,deg,pad,blk", SHAPES)
def test_frontier_bits_equal_jax_column_half(nc, nr, deg, pad, blk, wr):
    """The pull's column pass (its plain version, and the wrapper on the
    CPU) unpacked equals the column half of the JAX ``_proposals`` at
    every probe level, bit for bit."""
    g = random_bipartite(nc, nr, deg, seed=nc + 5 * nr, pad_to=pad)
    reset_launches()
    n_levels = 0
    for level, bfs, root, rm in _probe_levels(g, wr):
        rt = root if wr else None
        want = _jax_column_half(bfs, rt, level)
        args = (_t(bfs), _t(root) if wr else None, level)
        words = frontier_bits_ref(*args)
        got, past = _unpack(words, g.nc)
        np.testing.assert_array_equal(got, want, err_msg=f"level {level}")
        assert not past.any()
        assert torch.equal(frontier_bits(*args), words)
        n_levels += 1
    assert n_levels >= 2
    assert sum(LAUNCHES.values()) == 0


@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
@pytest.mark.parametrize("n_cols", [1, 31, 32, 33, 65])
def test_frontier_bits_tail_word_equals_jax_column_half(n_cols, wr):
    """nc + 1 columns that fill a word, stop short of one or spill one
    bit into the next: the same bits as the JAX column half, the bits past
    column nc zero."""
    rng = np.random.default_rng(n_cols)
    nc = n_cols - 1
    bfs = rng.choice(np.array([1, 2, 2, 3], np.int32), nc + 1)
    root = rng.integers(0, nc + 1, nc + 1).astype(np.int32) if wr else None
    want = _jax_column_half(bfs, root, 2)
    assert want.any()
    got, past = _unpack(frontier_bits_ref(
        _t(bfs), None if root is None else _t(root), 2), nc)
    np.testing.assert_array_equal(got, want)
    assert not past.any()


@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
def test_frontier_bits_on_malformed_inputs(wr):
    """The malformed state of ``test_out_of_range_edge_slots_propose_nothing``
    (NEG levels, roots from -3 to nc + 3).  Every column whose root is not
    negative (the plain body: every column) gets the JAX column half's bit,
    a too-large root included (JAX's gather fills INT_MIN there, which is
    no live level).  A negative root is out of range for the port and its
    column stays off, as the numpy oracle says; the JAX gather would wrap
    it to bfs[nc + 1 + root] instead, a state no solver reaches."""
    g, _, _, bfs, root, _ = _malformed_inputs()
    rt = root if wr else None
    got, past = _unpack(frontier_bits_ref(
        _t(bfs), _t(rt) if wr else None, 2), g.nc)
    assert not past.any()
    want = _jax_column_half(bfs, rt, 2)
    kept = root >= 0 if wr else np.ones(g.nc + 1, bool)
    np.testing.assert_array_equal(got[kept], want[kept])
    oracle = bfs == 2
    if wr:
        ok = (root >= 0) & (root <= g.nc)
        oracle &= ok & (bfs[np.clip(root, 0, g.nc)] >= 1)
        assert (root > g.nc).any() and (root < 0).any()
    np.testing.assert_array_equal(got, oracle)
    assert got.sum() > 5


def test_frontier_bits_wrapper_rejects_bad_inputs():
    bfs = torch.full((21,), 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        frontier_bits(bfs.long(), None, 2)
    with pytest.raises(ValueError, match="contiguous"):
        frontier_bits(torch.stack([bfs, bfs], 1)[:, 0], None, 2)
    with pytest.raises(ValueError, match="differ"):
        frontier_bits(bfs, bfs[:-1], 2)
    with pytest.raises(ValueError, match="sentinel"):
        frontier_bits(bfs[:0], None, 2)
    with pytest.raises(TypeError, match="level"):
        frontier_bits(bfs, None, 2**31)
    with pytest.raises(ValueError, match="device"):
        frontier_bits(bfs.to("meta"), None, 2)
