"""The harness finds a cell's parts by name, so a later change adds a cell,
a configuration, a traffic mix or a metric as new files; and
``BENCHMARK.json`` keeps to the benchmark's contract."""
import json
import re
import shutil

from bench import registry

ROOT = registry.ROOT
BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "bench" / "configs" / "apfb_plain.json").write_text(
        json.dumps({"solver": {"algo": "apfb", "kernel": "gpubfs"},
                    "warm_start": "karp_sipser"}))
    (tmp_path / "bench" / "traffic" / "kron12_closed.json").write_text(
        json.dumps({"loop": "solve", "graphs": {
            "family": "kron", "scale": 12, "edge_factor": 8, "pool": 2}}))
    (tmp_path / "bench" / "metrics" / "levels.solve.py").write_text(
        "def read(run):\n    return sum(run.rec.get('levels', ())) or None\n")
    bench["configs"].append(dict(name="apfb_plain", source="x",
                                 file="bench/configs/apfb_plain.json",
                                 reduced=[], why="x"))
    bench["workloads"].append(dict(name="kron12.solve", config="apfb_plain",
                                   traffic="kron12_closed", chips=1, why="x"))
    bench["per_layer"].append(dict(
        name="levels.solve", unit="levels", better="lower",
        source="program_counter", layer="solver steps", moves="solve_s",
        workloads=["kron12.solve"]))
    bench["end_to_end"][0]["workloads"].append("kron12.solve")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    b = registry.benchmark(tmp_path)
    cell = registry.workload(b, "kron12.solve")
    assert registry.config(b, cell["config"], tmp_path)["warm_start"] == \
        "karp_sipser"
    assert registry.traffic(cell["traffic"], tmp_path)["graphs"]["scale"] \
        == 12
    assert [m["name"] for m in registry.per_layer(b, "kron12.solve")] == \
        ["levels.solve"]
    assert "solve_s" in [m["name"] for m in registry.end_to_end(
        b, "kron12.solve")]

    class Run:
        rec = {"levels": [3, 4]}
    assert registry.reader("levels.solve", tmp_path)(Run()) == 7
    # the cells already there are as they were
    for name in ("kron21.solve", "kron.batch"):
        assert registry.per_layer(b, name) == registry.per_layer(BENCH, name)


def test_every_named_part_exists():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert {"solver", "warm_start"} <= set(cfg)
    for w in BENCH["workloads"]:
        registry.config(BENCH, w["config"])
        t = registry.traffic(w["traffic"])
        assert (ROOT / "bench" / "loops" / f"{t['loop']}.py").exists()
        assert (ROOT / "bench" / "families"
                / f"{t['graphs']['family']}.py").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(registry.reader(m["name"]))


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    cells = {w["name"] for w in BENCH["workloads"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and len(c["source"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:      # every cell: set-up, one more, one per-layer
        assert len(registry.end_to_end(BENCH, cell)) >= 2
        assert registry.per_layer(BENCH, cell)

