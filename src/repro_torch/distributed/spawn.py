"""Start a world of ranks and collect what each returns.

The JAX package is one controller; here a mesh over ``size`` ranks is
``size`` processes.  :func:`run_world` starts them with
``torch.multiprocessing``'s ``spawn`` start method (a rank never inherits
the parent's CUDA context), each joining the world through a ``file://``
store in a fresh temporary directory (no port to collide), and each calling
``fn(world, *args)``.  The results come back to the parent in rank order,
pickled by value, so a rank returns host data (numbers, numpy arrays, CPU
tensors).

If a rank raises, the parent kills the others and raises that rank's
traceback.  A rank that calls ``sys.exit(code)`` ends the world: once the
ranks have ended, the parent raises ``SystemExit`` with that code.  The
whole run is bounded by ``timeout`` (the world's collectives by the same):
past it every rank is killed and the parent raises ``TimeoutError``.  No
rank process outlives the call.
"""
from __future__ import annotations

import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.multiprocessing as mp

from .world import DEFAULT_TIMEOUT, close_world, init_world, mesh_shape

# seconds a rank has to report once its process has ended (its pipe drains)
_DRAIN = 5.0


class RankError(RuntimeError):
    """A rank of a world raised; the message holds its traceback."""


def _rank_main(fn, rank, size, init_method, device, timeout, args,
               results, mesh=None) -> None:
    """One rank: join the world, call ``fn``, report, leave."""
    code = 0
    # every rank of run_world is on this host: gloo's pairs over loopback
    # (its default interface, the host name's, took 3-4x longer a
    # collective on a CPU test host)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        world = init_world(rank, size, init_method, device=device,
                           timeout=timeout, mesh=mesh)
        out = fn(world, *args)
        results.put((rank, "ok", pickle.dumps(out)))
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
        results.put((rank, "exit", code))
    except BaseException:
        code = 1
        results.put((rank, "error", traceback.format_exc()))
    finally:
        try:
            close_world()
        except Exception:
            pass
        # the queue's feeder thread must flush the report before the exit
        results.close()
        results.join_thread()
    if code:
        os._exit(code)


def run_world(fn: Callable, size: int, *args, device=None,
              timeout: float = DEFAULT_TIMEOUT, mesh=None) -> List[Any]:
    """Run ``fn(world, *args)`` on each of ``size`` ranks (module doc);
    returns the ranks' results in rank order.  ``device`` as
    :func:`~.world.init_world` takes it (None: rank ``r`` on card ``r %
    device_count()``; ``"cpu"``: every rank on the CPU, one thread each);
    ``mesh``: ``(D, M)``, ``D * M = size`` (None: ``(size, 1)``).  ``fn``
    and ``args`` must pickle (a module-level function)."""
    mesh = mesh_shape(size, mesh)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="repro_torch_world_")
    init_method = "file://" + os.path.join(store, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, size, init_method, device, timeout,
                               args, results, mesh))
             for r in range(size)]
    got: dict = {}
    ended: dict = {}            # rank -> when its process was seen ended
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) < size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"a world of {size} ranks ran past its {timeout:.0f} s; "
                    f"ranks {sorted(set(range(size)) - set(got))} had not "
                    f"reported")
            try:
                rank, kind, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if r in got or p.exitcode is None:
                        continue
                    if now - ended.setdefault(r, now) >= _DRAIN:
                        raise RankError(
                            f"rank {r} of {size} ended (exit code "
                            f"{p.exitcode}) without reporting")
                continue
            if kind == "error":
                raise RankError(f"rank {rank} of {size} failed:\n{value}")
            got[rank] = (kind, value)
        exits = {v for k, v in got.values() if k == "exit"}
        if exits:
            raise SystemExit(max(exits))
        return [pickle.loads(got[r][1]) for r in range(size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
        results.close()
        shutil.rmtree(store, ignore_errors=True)

