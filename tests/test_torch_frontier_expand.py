"""The port's fused frontier sweep against the JAX package's.

On CPU tensors the port's ``frontier_expand_fused`` is its plain PyTorch
version; it must equal the JAX Pallas kernel run in interpret mode and the
JAX oracle ``frontier_expand_fused_ref``, bit for bit, for the WR and the
plain body, over several BFS levels of real probe states (the states the
JAX solver itself reaches).  The CUDA kernel is held against the same plain
version in ``tests/test_torch_gpu.py``, which runs only where there is a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cheap_matching_jax
from repro.graphs import random_bipartite
from repro.kernels.frontier_expand import (
    frontier_expand as jax_frontier_expand,
    frontier_expand_fused as jax_fused,
    frontier_expand_fused_ref as jax_fused_ref)
from repro.matching.solve import _apply_winner as jax_apply_winner
from repro.matching.solve import level0_state as jax_level0_state

from repro_torch.kernels.frontier_expand import (LAUNCHES,
                                                 frontier_expand_fused,
                                                 frontier_expand_ref,
                                                 reset_launches)

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


@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
def test_out_of_range_edge_slots_propose_nothing(wr):
    """Edge slots with a column outside [0, nc] or a row outside [0, nr),
    and columns whose root is outside [0, nc], are skipped, as the CUDA
    kernel skips them; nothing raises and no other row changes."""
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
    rt = root if wr else None
    got = frontier_expand_fused(_t(ecol), _t(cadj), _t(bfs),
                                _t(rt) if wr else None, _t(rmatch), 2)
    want = _winners_oracle(ecol, cadj, bfs, rt, rmatch, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < 2**30).sum() > 5          # the test proposes something


def test_wrapper_rejects_bad_inputs():
    g = random_bipartite(20, 20, 2.0, seed=1)
    e, c = _t(g.ecol), _t(g.cadj)
    bfs = torch.full((21,), 2, dtype=torch.int32)
    rm = torch.full((21,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        frontier_expand_fused(e.long(), c, bfs, None, rm, 2)
    with pytest.raises(ValueError, match="contiguous"):
        frontier_expand_fused(e, c, torch.stack([bfs, bfs], 1)[:, 0], None,
                              rm, 2)
    with pytest.raises(ValueError, match="differ"):
        frontier_expand_fused(e, c[:-1], bfs, None, rm, 2)
    with pytest.raises(ValueError, match="differ"):
        frontier_expand_fused(e, c, bfs, bfs[:-1], rm, 2)
    with pytest.raises(TypeError, match="level"):
        frontier_expand_fused(e, c, bfs, None, rm, torch.tensor(2))
    with pytest.raises(TypeError, match="level"):
        frontier_expand_fused(e, c, bfs, None, rm, 2**31)
    with pytest.raises(ValueError, match="device"):
        frontier_expand_fused(e.to("meta"), c.to("meta"), bfs.to("meta"),
                              None, rm.to("meta"), 2)
