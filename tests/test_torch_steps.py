"""The solver's and warm starts' device loops, on the CPU.

Every loop of a solve is a step run while its ``live`` flag is set, the
flag tested before every step: by the loop's WHILE node on a card, by the
host here.  So no step runs with its flag down: a loop entered with its
flag down changes no buffer of the entry (the matching, the BFS and
``ALTERNATE`` state, the loops' scalars, the device counts), tolerance 0.
And each loop stops by its own rule: the BFS level loop where the
reference's inner loop stops (APFB when no vertex was inserted, APsB at
its first augmenting level, ``tail_levels`` that many levels past it),
``ALTERNATE`` when no walker is left or at its step budget, a warm start's
rounds when a round commits nothing.
"""
import pytest
import torch

from repro_torch.graphs import instance_sets, kron_graph
from repro_torch.matching import MatcherConfig, TorchCSR
from repro_torch.matching.device_loop import Loop
from repro_torch.matching.solve import L0, MatcherProgram
from repro_torch.matching.warmstart import CHEAP, KARP_SIPSER


def _program(g, cfg, stages=(), csc=False):
    t = TorchCSR.from_host(g, device="cpu")
    if csc:
        t = t.with_csc()
    prog = MatcherProgram(t.nc, t.nr, t.nnz_pad, cfg, stages)
    P = prog.program("cpu")
    prog.load(P, t, None)
    return prog, P


def _snapshot(P):
    return {k: v.clone() for k, v in P.buf.items()}


def _unchanged(P, before, what):
    for k, v in P.buf.items():
        assert torch.equal(v, before[k]), f"{what}: {k} changed"


def _flag_down_runs_nothing(P, loop, what):
    """``loop`` entered with its flag down changes no buffer."""
    P.set(loop.live, 0)
    before = _snapshot(P)
    P.loop(Loop(loop.name, loop.body, loop.live, start=False))
    _unchanged(P, before, what)


@pytest.mark.parametrize("stages,name", [(CHEAP, "cheap"),
                                         (KARP_SIPSER, "karp_sipser")],
                         ids=["cheap", "karp_sipser"])
@pytest.mark.parametrize("family", ["rand", "free", "comb"])
def test_warm_start_rounds_stop_when_a_round_commits_nothing(family, stages,
                                                             name):
    _, P = _program(instance_sets("mini")[family], None, stages)
    loop = stages[0]
    assert loop.name == name
    P.set(loop.live, 1)
    loop.step(P.buf)                             # a live round first
    _flag_down_runs_nothing(P, loop, f"{name} rounds, flag put down")
    P.loop(loop)                                 # to its end
    assert P.read(loop.live) == [0]
    # the loop stopped because a round commits nothing: one more commits
    # nothing either
    before = _snapshot(P)
    loop.step(P.buf)
    _unchanged(P, before, f"{name} round past the loop's end")


_LEVEL_CONFIGS = {
    "apfb_wr": dict(),
    "plain": dict(kernel="gpubfs"),
    "apsb": dict(algo="apsb"),
    "tail_levels": dict(tail_levels=1),
    "wr_exact": dict(algo="apsb", wr_exact=True),
    "legacy": dict(use_pallas=True, pallas_fused=False),
    "dirop_pallas": dict(dirop=True, use_pallas=True, dirop_alpha=1.0,
                         dirop_beta=64.0),
}


@pytest.mark.parametrize("name", sorted(_LEVEL_CONFIGS))
@pytest.mark.parametrize("family", ["rand", "grid", "kron"])
def test_bfs_level_loop_stops_by_its_rule(family, name):
    cfg = MatcherConfig(**_LEVEL_CONFIGS[name])
    prog, P = _program(instance_sets("mini")[family], cfg, CHEAP,
                       csc=cfg.dirop)
    P.run_stages(CHEAP)
    s = prog.solver
    P.once(s.phase_begin)
    _flag_down_runs_nothing(P, s.level, f"{name} level L0, flag down")
    P.set("bfs_live", 1)
    counts = P.buf.counts.clone()
    P.loop(s.level)                              # to the phase's end
    level, ins, aug, aug_lvl, live = P.read("level", "ins", "aug",
                                            "aug_lvl", "bfs_live")
    assert live == 0
    assert int(P.buf.counts[0] - counts[0]) == level - L0
    if cfg.algo == "apsb":
        # stopped at its first augmenting level (or when nothing was
        # inserted before one)
        assert (aug == 1 and level == aug_lvl + 1) or (aug == 0
                                                       and ins == 0)
    elif cfg.tail_levels > 0:
        assert ins == 0 or level > aug_lvl + cfg.tail_levels
    else:
        assert ins == 0
    _flag_down_runs_nothing(P, s.level, f"{name} level past the phase's end")


@pytest.mark.parametrize("take", [False, True], ids=["push", "compact"])
@pytest.mark.parametrize("path", ["adaptive", "dirop"])
def test_branch_level_loop_with_its_flag_down_runs_nothing(path, take):
    cfg = MatcherConfig(adaptive_frontier=path == "adaptive",
                        dirop=path == "dirop")
    prog, P = _program(instance_sets("mini")["grid"], cfg, CHEAP,
                       csc=cfg.dirop)
    P.run_stages(CHEAP)
    P.once(prog.solver.phase_begin)
    P.set("plan", int(take))
    prog.solver.level.step(P.buf)                # one live level
    P.set("plan", int(take))
    _flag_down_runs_nothing(P, prog.solver.level, f"{path} level ({take})")


@pytest.mark.parametrize("cfg_kw", [dict(), dict(algo="apsb", wr_exact=True),
                                    dict(kernel="gpubfs")], ids=str)
@pytest.mark.parametrize("family", ["rand", "comb"])
def test_alternate_loop_stops_with_no_walker_left(family, cfg_kw):
    prog, P = _program(instance_sets("mini")[family],
                       MatcherConfig(**cfg_kw), CHEAP)
    P.run_stages(CHEAP)
    s = prog.solver
    P.once(s.phase_begin)
    P.loop(s.level)
    assert P.read("aug") == [1]
    P.once(s.alt_begin)
    s.alt.step(P.buf)
    _flag_down_runs_nothing(P, s.alt, "ALTERNATE, flag put down")
    P.set("alt_live", 1)
    P.loop(s.alt)
    steps = P.read("steps")[0]
    assert steps < s.max_steps and bool((P.buf.cur < 0).all())
    _flag_down_runs_nothing(P, s.alt, "ALTERNATE past the walk's end")


def test_loop_with_its_flag_down_counts_nothing():
    """A level adds one level (one push level) to the device counts; a
    level loop entered with its flag down adds nothing."""
    prog, P = _program(kron_graph(7, 8, seed=2), MatcherConfig(), CHEAP)
    P.run_stages(CHEAP)
    s = prog.solver
    P.once(s.phase_begin)
    counts = P.buf.counts
    before = counts.clone()
    s.level.step(P.buf)
    assert (counts - before).tolist() == [1, 1, 0, 0, 0, 0]
    P.set("bfs_live", 0)
    P.loop(s.level)
    assert (counts - before).tolist() == [1, 1, 0, 0, 0, 0]


def test_runaway_loop_raises_after_the_call_and_load_clears_it():
    """A loop that hits its runaway guard with no read after it (the
    warm-start rounds of the ``"init"`` entry) makes the call raise; the
    next call starts with the guard cleared."""
    g = instance_sets("mini")["rand"]
    t = TorchCSR.from_host(g, device="cpu")
    prog = MatcherProgram(t.nc, t.nr, t.nnz_pad, None, CHEAP)
    P = prog.program("cpu")
    limit, P.loop_limit = P.loop_limit, 1       # cheap needs more rounds
    with pytest.raises(RuntimeError, match="stopped"):
        prog(t)
    P.loop_limit = limit
    st = prog(t)
    assert int((st.cmatch[:-1] >= 0).sum()) > 0
