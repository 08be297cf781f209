"""admit_ms.batch: mean milliseconds a ``submit`` call took on the caller's
thread (validation, bucketing, upload, enqueue)."""
from bench import stats


def read(run):
    adm = [r["admitted"] - r["sent"] for r in run.rec.get("requests", ())
           if r["admitted"] is not None]
    return stats.mean(adm) * 1e3 if adm else None
