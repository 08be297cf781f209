"""levels.solve: mean BFS levels a solve, counted by the solver on the
device (``SolveCounters.levels``)."""
from bench import stats


def read(run):
    levels = run.rec.get("levels")
    return stats.mean(levels) if levels else None
