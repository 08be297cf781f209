"""The port's adaptive and direction-optimizing sweeps against the JAX
package's, level by level.

At every level of real BFS phases (the states the JAX solver reaches from a
warm start) the unreached-row mask, the frontier, the compact column and
row gathers and the streaming pull return the JAX functions' integers,
tolerance 0; and the solver's own BFS level step (the step
``Matcher.run`` loops over) on the adaptive and direction-optimizing
paths returns, level by level, what the JAX ``_expand_level`` and
``_expand_level_dirop`` return (``dir_prev`` carried, its ``use_pull``
decision included).  The JAX side runs with ``JAX_PLATFORMS=cpu``, its Pallas
pull kernel in interpret mode; the port runs on the CPU, where every
index that leaves its range raises.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.matching.solve as js
from repro.graphs import instance_sets
from repro.matching import DeviceCSR, Matcher as RefMatcher

import repro_torch.matching.solve as ts
from repro_torch.matching import MatcherConfig, MatchState, TorchCSR


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.int32))


def _eq(a, b, msg=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=msg)


def _state(g, ws="cheap"):
    st = RefMatcher(warm_start=ws).init(DeviceCSR.from_host(g))
    return st.cmatch, st.rmatch


def _jit(fn, **static):
    """``fn`` with its keyword options bound and compiled once: stepping a
    JAX level function eagerly, op by op, is what makes these tests slow."""
    return jax.jit(functools.partial(fn, **static))


def _phase_walk(g, wr, ws="cheap"):
    """Yield the JAX solver's (level, bfs, root, pred, rmatch) at every
    level of the first BFS phase from ``ws`` (the states the solver
    reaches), advancing with the dense sweep."""
    cm, rm = _state(g, ws)
    bfs, root = js.level0_state(cm)
    pred = jnp.full(g.nr + 1, g.nc, jnp.int32)
    ecol, cadj = jnp.asarray(g.ecol), jnp.asarray(g.cadj)
    step = _jit(js._expand_level, wr=wr, wr_exact=False, use_pallas=False,
                block_edges=128)
    for level in range(2, 2 + g.nc):
        yield level, bfs, root, pred, rm
        bfs, root, pred, rm, ins, _ = step(ecol, cadj, bfs, root, pred, rm,
                                           jnp.int32(level))
        if not bool(ins):
            return


def _solver_at_level0(g, cfg, cm, rm):
    """The solver of ``cfg`` on a CPU program holding ``g`` (with its CSC
    mirror) and the matching ``cm``/``rm``, its phase begun: its buffers
    hold the state the first BFS level starts from."""
    t = TorchCSR.from_host(g, device="cpu").with_csc()
    prog = ts.MatcherProgram(t.nc, t.nr, t.nnz_pad, cfg, None)
    P = prog.program("cpu")
    zero = torch.zeros((), dtype=torch.int32)
    prog.load(P, t, MatchState(cmatch=_t(cm), rmatch=_t(rm), phases=zero,
                               fallbacks=zero, certified=zero.bool()))
    P.once(prog.solver.phase_begin)
    return prog.solver, P


def _level_outputs(P):
    """The solver's BFS state and this level's flags, as the JAX level
    function returns them."""
    B = P.buf
    return B.bfs, B.root, B.pred, B.rmb, bool(B.ins), bool(B.aug)


def _mirror(g):
    d = DeviceCSR.from_host(g).with_csc()
    return d, {f: _t(getattr(d, f)) for f in ("cxadj", "cadj", "ecol",
                                               "rxadj", "radj", "erow")}


@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
@pytest.mark.parametrize("family", ["rand", "grid", "free", "kron"])
def test_compact_and_pull_sweeps_equal_reference(family, wr):
    """At every level of a real phase: the unreached-row mask, the compact
    column gather, the compact row gather (at a geometry that fits and at
    one that truncates) and the streaming pull (kernel and dense form)
    give the JAX package's vectors."""
    g = instance_sets("mini")[family]
    d, t = _mirror(g)
    nr = g.nr
    compact = {cap: _jit(js._winner_compact, nr=nr, cap=cap, dmax=dmax)
               for cap, dmax in ((1024, 64), (8, 2))}
    pull_compact = {cap: _jit(js._winner_pull_compact, nr=nr, cap=cap,
                              dmax=dmax)
                    for cap, dmax in ((1024, 64), (8, 2))}
    stream = {p: _jit(js._winner_pull_stream, nr=nr, use_pallas=p,
                      block_edges=128, interpret=True) for p in (True, False)}
    n = 0
    for level, bfs, root, pred, rm in _phase_walk(g, wr):
        tb, tr, tm = _t(bfs), _t(root), _t(rm)
        rt, trt = (root, tr) if wr else (None, None)
        unr = js._unreached_rows(bfs, rm)
        tunr = ts._unreached_rows(tb, tm)
        _eq(tunr, unr, f"unreached level {level}")
        isf = bfs[:-1] == level
        if wr:
            isf &= bfs[jnp.clip(root[:-1], 0, g.nc)] >= js.UNVISITED
        tisf = ts._frontier(tb, tr, level, wr)
        _eq(tisf, isf, f"frontier level {level}")
        for cap, dmax in ((1024, 64), (8, 2)):
            _eq(ts._winner_compact(t["cxadj"], t["cadj"], tb, tm, tisf,
                                   cap=cap, dmax=dmax),
                compact[cap](d.cxadj, d.cadj, bfs, rm, isf=isf),
                f"compact level {level} cap {cap}")
            _eq(ts._winner_pull_compact(t["rxadj"], t["radj"], tb, trt, tm,
                                        level, tunr, cap=cap, dmax=dmax),
                pull_compact[cap](d.rxadj, d.radj, bfs, rt, rm,
                                  jnp.int32(level), unreached=unr),
                f"pull compact level {level} cap {cap}")
        for use_pallas in (True, False):
            _eq(ts._winner_pull_stream(t["radj"], t["erow"], tb, trt, tm,
                                       level, use_pallas=use_pallas),
                stream[use_pallas](d.radj, d.erow, bfs, rt, rm,
                                   jnp.int32(level)),
                f"pull stream level {level}")
        n += 1
    assert n >= 2


@pytest.mark.parametrize("geom", [(0, 0), (64, 2), (4, 8)],
                         ids=["auto", "dmax2", "cap4"])
@pytest.mark.parametrize("family", ["rand", "grid", "free", "kron"])
def test_adaptive_expand_level_equals_reference(family, geom):
    """The solver's adaptive level step at every level of a phase, every
    output, with the compact branch eligible on some levels."""
    g = instance_sets("mini")[family]
    cfg = MatcherConfig(adaptive_frontier=True, compact_cap=geom[0],
                        compact_dmax=geom[1])
    cap, dmax = cfg.resolve_cap(cfg.compact_cap, g.nc), cfg.resolve_dmax(
        cfg.compact_dmax)
    d, _ = _mirror(g)
    cm, rm = _state(g)
    jst = js.level0_state(cm) + (jnp.full(g.nr + 1, g.nc, jnp.int32), rm)
    step = _jit(js._expand_level, wr=True, wr_exact=False, use_pallas=False,
                block_edges=128, adaptive=True, compact_cap=cap,
                compact_dmax=dmax)
    deg = d.cxadj[1:] - d.cxadj[:-1]
    ts.COUNTERS.reset()
    solver, P = _solver_at_level0(g, cfg, cm, rm)
    jaug = False
    for level in range(2, 2 + g.nc):
        assert P.read("level", "bfs_live") == [level, 1]
        # the branch decision, against the reference's rule (solve.py:309)
        bfs, root = jst[0], jst[1]
        isf = (bfs[:-1] == level) & (
            bfs[jnp.clip(root[:-1], 0, g.nc)] >= js.UNVISITED)
        want = (jnp.sum(isf.astype(jnp.int32)) <= cap) & (
            jnp.max(jnp.where(isf, deg, 0)) <= dmax)
        assert P.read("plan") == [int(want)], f"eligible level {level}"
        jout = step(d.ecol, d.cadj, *jst, jnp.int32(level), cxadj=d.cxadj)
        solver.level.step(P.buf)
        jaug |= bool(jout[5])
        for name, a, b in zip(("bfs", "root", "pred", "rmatch", "ins",
                               "aug"), _level_outputs(P),
                              jout[:5] + (jaug,)):
            _eq(a, b, f"{name} level {level}")
        jst = jout[:4]
        if not bool(jout[4]):
            break
    assert P.read("bfs_live") == [0]
    assert ts.COUNTERS.push_levels + ts.COUNTERS.compact_levels == \
        level - 1


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["compact_pull", "pull_kernel"])
@pytest.mark.parametrize("alpha,beta", [(8.0, 32.0), (1.0, 64.0),
                                        (1e6, 1e6), (1e-6, 1e-6)],
                         ids=["default", "wide", "pull", "push"])
@pytest.mark.parametrize("family", ["rand", "grid", "kron", "free"])
def test_dirop_expand_level_equals_reference(family, alpha, beta,
                                             use_pallas):
    """The solver's direction-optimizing level step over a whole phase of
    an APFB solve from the cheap warm start, ``dir_prev`` carried: every
    output equals the JAX ``_expand_level_dirop``'s at every level, the
    direction ``use_pull`` included."""
    g = instance_sets("mini")[family]
    cfg = MatcherConfig(dirop=True, use_pallas=use_pallas,
                        dirop_alpha=alpha, dirop_beta=beta)
    pcap, pdmax = cfg.resolve_cap(0, g.nr), cfg.resolve_dmax(0)
    d, _ = _mirror(g)
    cm, rm = _state(g)
    jst = js.level0_state(cm) + (jnp.full(g.nr + 1, g.nc, jnp.int32), rm)
    jprev, dirs, jaug = jnp.bool_(False), [], False
    step = _jit(js._expand_level_dirop, wr=True, wr_exact=False,
                use_pallas=use_pallas, block_edges=128, axis=None,
                pallas_fused=True, interpret=True, dirop_alpha=alpha,
                dirop_beta=beta, pull_cap=pcap, pull_dmax=pdmax)
    solver, P = _solver_at_level0(g, cfg, cm, rm)
    for level in range(2, 2 + g.nc):
        assert P.read("level", "bfs_live") == [level, 1]
        jout = step(d.ecol, d.cadj, d.cxadj, d.rxadj, d.radj, d.erow, *jst,
                    jnp.int32(level), jprev)
        solver.level.step(P.buf)
        jaug |= bool(jout[5])
        for name, a, b in zip(("bfs", "root", "pred", "rmatch", "ins",
                               "aug"), _level_outputs(P),
                              jout[:5] + (jaug,)):
            _eq(a, b, f"{name} level {level}")
        use_pull = P.read("dir_prev")[0] == 1
        assert use_pull is bool(jout[6]), f"use_pull level {level}"
        dirs.append(use_pull)
        jst, jprev = jout[:4], jout[6]
        if not bool(jout[4]):
            break
    assert P.read("bfs_live") == [0]
    if alpha == 1e6 and use_pallas:
        assert any(dirs)                # the kernel pulls, no fit needed
