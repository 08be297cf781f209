"""occupancy.batch: real requests over padded batch lanes of the flushes in
the window (``ServiceMetrics`` ``batch_real`` / ``batch_padded``)."""


def read(run):
    svc = run.rec.get("service")
    if not svc or not svc["batch_padded"]:
        return None
    return svc["batch_real"] / svc["batch_padded"]
