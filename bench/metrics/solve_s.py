"""solve_s: the window's seconds over the solves completed in it, each a
host graph in and its matching on the host (closed loop, back to back)."""


def read(run):
    ends = run.rec.get("ends")
    return run.rec["window_s"] / len(ends) if ends else None
