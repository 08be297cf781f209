"""Tiny traffic for the CPU tests: every loop of the benchmark, at sizes a
test run holds, driven through ``bench.run.run_cell`` with the CPU as the
device (the command itself refuses to run without a card)."""
from bench import registry
from bench.run import run_cell

SERVICE = dict(min_vertices=256, max_vertices=512, edge_factor=32,
               max_batch=4, max_delay_ms=2, cache_gib=1)
KRON = dict(family="kron", edge_factor=16,
            sizes=[dict(scale=8, count=4), dict(scale=9, count=2)])
MESH = dict(family="mesh", side=16, rcp=True, pool=3)

TRAFFIC = {
    "kron21.solve": dict(loop="solve", graphs=dict(
        family="kron", scale=9, edge_factor=16, pool=3, pad="bucket")),
    "mesh20.solve": dict(loop="solve", graphs=dict(
        family="mesh", side=24, rcp=True, pool=2)),
    "kron.batch": dict(loop="closed", graphs=KRON, service=SERVICE,
                       callers=6),
}


def run(cell, seed=2**31 + 5, seconds=1.0, trace=False, graphs=None,
        override=None):
    """One CPU run of ``cell`` at a tiny size; ``graphs`` replaces its
    traffic's graph spec."""
    bench = registry.benchmark()
    traffic = dict(TRAFFIC[cell])
    if graphs is not None:
        traffic["graphs"] = graphs
    config = registry.workload(bench, cell)["config"]
    metrics = (registry.per_layer(bench, cell) if trace
               else registry.end_to_end(bench, cell))
    return run_cell(registry.config(bench, config), traffic, metrics, seed,
                    seconds, trace, device="cpu", override=override)
