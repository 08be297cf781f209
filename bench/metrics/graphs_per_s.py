"""graphs_per_s: requests whose result came inside the window, over the
window's seconds (closed loop)."""


def read(run):
    rows = run.rec.get("requests")
    if not rows:
        return None
    close = run.t0 + run.seconds
    return sum(1 for r in rows
               if r["done"] is not None and r["done"] <= close) / run.seconds
