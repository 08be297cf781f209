"""host_syncs.solve: mean ``SolveCounters.host_syncs`` a solve (the
solver's reads of device values that the host waits for)."""
from bench import stats


def read(run):
    syncs = run.rec.get("host_syncs")
    return stats.mean(syncs) if syncs else None
