"""The port's ``torch.distributed`` layer (``repro_torch.distributed``) on the
CPU: gloo worlds of 2 and 4 ranks.

* ``init_world``'s choice of backend from where the ranks sit, and its
  refusals;
* each collective (``all_reduce_min_``, ``all_reduce_sum_``,
  ``broadcast_``, ``reduce_scatter_mean``, ``all_gather_into`` along dims
  0 and 1) on every rank against its one-process value from the same
  seeded inputs, exactly (the sums and means within 1e-6);
* ``run_world``: a rank that raises ends the world with that rank's
  traceback, one that dies without a word or hangs ends it within the
  timeout, and ``sys.exit(17)`` on every rank comes back as
  ``SystemExit(17)``; no rank process outlives a call.

Each world starts through ``run_world`` (a ``file://`` store, a timeout,
which is each test's time limit); one world of each size serves every
collective case (module fixtures).
"""
import multiprocessing
import os
import time

import pytest
import torch

import torch_world_ranks as ranks
from repro_torch.distributed import (RankError, World, choose_backend,
                                     close_world, current_world, init_world,
                                     rank_devices, require_world, run_world)
from repro_torch.distributed import comm

SIZES = (2, 4)
CASES = ("all_reduce_min", "all_reduce_sum", "broadcast",
         "reduce_scatter_0", "reduce_scatter_1", "all_gather_0",
         "all_gather_1")


class _Rank:
    """A stand-in world for the one-process values: rank ``r`` of ``n``."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size


def want(case: str, size: int, rank: int) -> torch.Tensor:
    """The one-process value of ``case`` on ``rank``."""
    every = [_Rank(r, size) for r in range(size)]
    if case == "all_reduce_min":
        return torch.stack([ranks.ranked(w, (37,), torch.int32)
                            for w in every]).amin(0)
    if case == "all_reduce_sum":
        out = torch.zeros(3, 5)
        for w in every:
            out += ranks.ranked(w, (3, 5))
        return out
    if case == "broadcast":
        return ranks.ranked(every[-1], (11,))
    kind, dim = case.rsplit("_", 1)
    dim = int(dim)
    if kind == "reduce_scatter":
        shape = [2, 3]
        shape[dim] *= size
        mean = sum(ranks.ranked(w, tuple(shape)) for w in every) / size
        return mean.chunk(size, dim)[rank]
    return torch.cat([ranks.ranked(w, (2, 3)) for w in every], dim)


@pytest.fixture(scope="module", params=SIZES)
def world_results(request):
    return request.param, run_world(ranks.collectives, request.param,
                                    device="cpu", timeout=120)


@pytest.mark.parametrize("case", CASES)
def test_collective_equals_one_process_value(world_results, case):
    size, results = world_results
    for rank, got in enumerate(results):
        assert got["rank"] == rank and got["backend"] == "gloo"
        w = want(case, size, rank)
        if w.dtype == torch.int32:
            assert torch.equal(got[case], w), (case, rank)
        else:
            torch.testing.assert_close(got[case], w, rtol=1e-6, atol=1e-6)


def test_backend_choice():
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert choose_backend([cpu, cpu]) == "gloo"
    assert choose_backend([card, card]) == "gloo"        # a shared card
    assert choose_backend([card, torch.device("cuda", 1)]) == "nccl"
    assert choose_backend([card]) == "nccl"
    assert rank_devices(3, "cpu") == (cpu,) * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            rank_devices(2)


def test_a_world_of_one_in_process(tmp_path):
    """``init_world`` in this process: gloo on the CPU, ``current_world``
    until ``close_world``, every collective the identity."""
    assert current_world() is None
    with pytest.raises(ValueError, match="init_world"):
        require_world()
    w = init_world(0, 1, f"file://{tmp_path}/store", device="cpu",
                   timeout=30)
    try:
        assert isinstance(w, World) and current_world() is w
        assert (w.rank, w.size, w.backend, w.device) == (
            0, 1, "gloo", torch.device("cpu"))
        with pytest.raises(RuntimeError, match="already rank 0"):
            init_world(0, 1, f"file://{tmp_path}/other")
        x = torch.arange(6.).reshape(2, 3)
        assert torch.equal(comm.all_reduce_min_(x.clone()), x)
        assert torch.equal(comm.reduce_scatter_mean(x, 1), x)
        out = torch.empty(2, 3)
        assert torch.equal(comm.all_gather_into(out, x, 1), x)
        before = comm.counts()["all_reduce"]["calls"]
        comm.all_reduce_sum_(x.clone())
        assert comm.counts()["all_reduce"] == dict(
            calls=before + 1, bytes=comm.counts()["all_reduce"]["bytes"])
    finally:
        close_world()
    assert current_world() is None


def test_init_world_refusals(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="not in a world of 2"):
        init_world(2, 2, f"file://{tmp_path}/s", device="cpu")
    with pytest.raises(ValueError, match="init_method"):
        init_world(0, 2, device="cpu")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        init_world()
    assert current_world() is None


def _no_rank_left():
    return not [p for p in multiprocessing.active_children()
                if p.name.startswith(("Process", "SpawnProcess"))]


def test_a_rank_that_raises_ends_the_world_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 1 of 3 failed") as e:
        run_world(ranks.fails, 3, "raise", device="cpu", timeout=40)
    assert "rank 1 fails on purpose" in str(e.value)
    assert "torch_world_ranks.py" in str(e.value)       # the traceback
    assert time.monotonic() - t0 < 40
    assert _no_rank_left()


def test_a_rank_that_vanishes_ends_the_world():
    """Rank 1 dies without a word: its end is seen, or its peer's
    collective fails on the broken connection first."""
    with pytest.raises(RankError, match="rank (1 of 2 ended|0 of 2 failed)"):
        run_world(ranks.fails, 2, "vanish", device="cpu", timeout=40)
    assert _no_rank_left()


def test_a_hung_rank_ends_the_world_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RankError)):
        run_world(ranks.fails, 2, "hang", device="cpu", timeout=12)
    assert time.monotonic() - t0 < 30
    assert _no_rank_left()


def test_every_rank_exiting_17_exits_17():
    with pytest.raises(SystemExit) as e:
        run_world(ranks.fails, 2, "exit", device="cpu", timeout=40)
    assert e.value.code == 17
    assert _no_rank_left()


def test_the_store_is_a_fresh_file():
    """Two worlds at once (as two test workers start them) share no
    store."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        a, b = ex.map(lambda n: run_world(ranks.collectives, n,
                                          device="cpu", timeout=120),
                      (2, 2))
    assert [r["rank"] for r in a] == [r["rank"] for r in b] == [0, 1]
    assert not os.environ.get("MASTER_PORT")


def test_init_world_reads_torchruns_environment(monkeypatch):
    """``init_world()`` with no rank joins torchrun's world from
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (here a
    world of one on a free loopback port)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    w = init_world(device="cpu", timeout=30)
    try:
        assert (w.rank, w.size, w.backend) == (0, 1, "gloo")
        assert torch.equal(comm.all_reduce_sum_(torch.ones(3)),
                           torch.ones(3))
    finally:
        close_world()


def test_init_world_under_torchrun_without_a_card_raises(monkeypatch):
    """Under torchrun with no card and no ``device``, ``init_world()``
    raises as every entry point does: the CPU only where ``device="cpu"``
    is asked for."""
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_world(timeout=5)
    assert current_world() is None
