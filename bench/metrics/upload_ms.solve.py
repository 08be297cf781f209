"""upload_ms.solve: mean milliseconds of ``TorchCSR.from_host`` a solve,
a span that ends in a device sync (traced runs)."""
from bench import stats


def read(run):
    ups = run.rec.get("upload_s")
    return stats.mean(ups) * 1e3 if ups and run.tracer.enabled else None
