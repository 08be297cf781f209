"""The comparison that decides ``correct`` fails what it must.

The control: the program's own lower guarantee, a solve cut to one phase
with ``degrade_maximal`` (a maximal matching, not a maximum one), in the
program's place.  Then a whole run, the card's check skipped, with the
timed path broken underneath, once for each fault a cell can have: the
solver returning its state unchanged, half of a batch left out, and an
answer altered where it is produced.  (No cell spans chips, so no exchange
between chips can be left out.)
"""
import importlib

import numpy as np
import pytest

from bench.control import CONTROL
from bench.loops import served
from bench.tests import tiny

MESH = dict(family="mesh", side=16, rcp=True, pool=3)
SOLVES = ["kron21.solve", "mesh20.solve"]
SERVED = ["kron.batch"]


@pytest.fixture
def short_wait(monkeypatch):
    monkeypatch.setattr(served, "WAIT_S", 1.0)


def after_setup(monkeypatch, cell, faults):
    """Plant ``faults`` (``(object, name, value)``) once the cell's set-up
    is done, so that they break the timed path."""
    loop = importlib.import_module(
        f"bench.loops.{tiny.TRAFFIC[cell]['loop']}")
    setup = loop.setup

    def armed(run):
        setup(run)
        for obj, name, value in faults:
            monkeypatch.setattr(obj, name, value)

    monkeypatch.setattr(loop, "setup", armed)


@pytest.mark.parametrize("cell", SOLVES + SERVED)
def test_the_control_is_not_correct(cell):
    graphs = None if cell == "mesh20.solve" else MESH
    out = tiny.run(cell, graphs=graphs, override=CONTROL)
    assert out["correct"] is False
    assert out["checks"]["aug_rows"]["value"] > 0
    assert out["checks"]["bad_pairs"]["value"] == 0     # valid, not maximum


@pytest.mark.parametrize("cell", SOLVES + SERVED)
def test_a_state_returned_unchanged_is_caught(cell, monkeypatch):
    from repro_torch.matching import Matcher, MatchState
    after_setup(monkeypatch, cell, [
        (Matcher, "run", lambda self, g, state=None:
         MatchState.fresh(g.nc, g.nr, g.device)),
        (Matcher, "run_many", lambda self, g, states=None:
         MatchState.fresh(g.nc, g.nr, g.device, g.batch_shape))])
    out = tiny.run(cell)
    assert out["correct"] is False
    assert out["checks"]["aug_rows"]["value"] > 0


@pytest.mark.parametrize("cell", SERVED)
def test_half_of_a_batch_left_out_is_caught(cell, monkeypatch, short_wait):
    from repro_torch.serving import MatchingService
    resolve = MatchingService._resolve_batch

    def first_half(self, reqs, *args, **kw):
        return resolve(self, reqs[: (len(reqs) + 1) // 2], *args, **kw)

    after_setup(monkeypatch, cell,
                [(MatchingService, "_resolve_batch", first_half)])
    out = tiny.run(cell, seconds=0.5)
    assert out["correct"] is False
    assert out["checks"]["missing"]["value"] > 0 and out["failed"] > 0


@pytest.mark.parametrize("cell", SOLVES + SERVED)
def test_an_altered_answer_is_caught(cell, monkeypatch):
    from repro_torch.matching import MatchState
    to_host = MatchState.to_host

    def altered(self):
        cm, rm = to_host(self)
        cm = cm.copy()
        c = int(np.argmax(cm >= 0))
        cm[c] = (cm[c] + 1) % max(len(rm), 1)
        return cm, rm

    after_setup(monkeypatch, cell, [(MatchState, "to_host", altered)])
    out = tiny.run(cell)
    assert out["correct"] is False
    assert out["checks"]["bad_pairs"]["value"] > 0
