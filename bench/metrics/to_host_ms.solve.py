"""to_host_ms.solve: mean milliseconds of ``MatchState.to_host`` a solve,
the matching copied back to the host."""
from bench import stats


def read(run):
    downs = run.rec.get("to_host_s")
    return stats.mean(downs) * 1e3 if downs else None
