"""Finds what a cell is made of by name, from files of their own.

``BENCHMARK.json`` (at the checkout's root) lists the cells, configurations
and metrics.  For a cell the harness reads

* its configuration: the file its ``configs`` entry names
  (``bench/configs/<config>.json``: the solver and warm start);
* its traffic: ``bench/traffic/<traffic>.json``, the parameters that the
  general loop ``bench/loops/<loop>.py`` (named by the traffic's ``loop``)
  and the graph family ``bench/families/<family>.py`` read;
* each metric's reader: ``bench/metrics/<metric>.py``, whose ``read(run)``
  returns the number, or None where the run has nothing to read.

A new cell, configuration, traffic mix or metric is a new file and a new
entry; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List

ROOT = Path(__file__).resolve().parents[1]


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "bench" / "traffic" / f"{name}.json")
                      .read_text())


def reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``bench/metrics/<name>.py``, loaded from its file."""
    path = Path(root) / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def end_to_end(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics ``cell`` reports."""
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics ``cell`` reports: those that list it, and
    those with no list whose end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
