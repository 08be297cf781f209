"""run_ms.solve: mean device milliseconds of ``Matcher.run`` a solve (the
warm start, the solver's steps and its kernels), between CUDA events
recorded on the stream before and after the call (traced runs)."""
from bench import stats


def read(run):
    runs = [v for v in run.rec.get("run_s") or () if v is not None]
    return stats.mean(runs) * 1e3 if runs else None
