"""The dry run's records as one markdown table (``PERF.md``'s).

``python -m repro_torch.launch.dryrun --all --both-meshes`` writes a
record a cell to ``experiments/dryrun_torch/``; this prints one row per
(arch, shape), the two production meshes side by side as ``16x16 /
2x16x16``: TFLOP, GB of op traffic and GB handed to collectives (by axis)
of the rank whose terms are larger, its argument bytes, the peak
estimate, and the dominant term with its seconds.

    python tools/dryrun_table.py [experiments/dryrun_torch]
"""
import glob
import json
import os
import sys

MESHES = ("16x16", "2x16x16")


def _pair(a, b, fmt="{:.3g}") -> str:
    return " / ".join("—" if x is None else fmt.format(x) for x in (a, b))


def main(root: str = "experiments/dryrun_torch") -> int:
    cells = {}
    for path in sorted(glob.glob(os.path.join(root, "*.json"))):
        rec = json.load(open(path))
        cells.setdefault((rec["arch"], rec["shape"]), {})[rec["mesh"]] = rec
    print("| arch | shape | TFLOP | op GB | collective GB (model + data) "
          "| argument GB | peak GB (est.) | dominant, s |")
    print("|---|---|---|---|---|---|---|---|")
    for (arch, shape), by_mesh in sorted(cells.items()):
        recs = [by_mesh.get(m) for m in MESHES]

        def get(fn):
            return [None if r is None else fn(r) for r in recs]

        def axis(r, name):
            top = max(r["ranks"], key=lambda x: max(x["terms"].values()))
            return sum(c["bytes"] for c in top["collective_detail"].get(
                name, {}).values()) / 1e9

        coll = get(lambda r: f"{axis(r, 'model'):.3g} + "
                             f"{axis(r, 'data'):.3g}")
        dom = get(lambda r: f"{r['dominant'][:-2]} "
                            f"{r['terms'][r['dominant']]:.3g}")
        mem = [None if r is None else r["memory"] for r in recs]
        print(f"| {arch} | {shape} "
              f"| {_pair(*get(lambda r: r['flops_total'] / 1e12))} "
              f"| {_pair(*get(lambda r: r['bytes_total'] / 1e9))} "
              f"| {' / '.join(c or '—' for c in coll)} "
              f"| {_pair(*[m and m['argument_bytes'] / 1e9 for m in mem])} "
              f"| {_pair(*[m and m['peak_bytes'] / 1e9 for m in mem])} "
              f"| {' / '.join(d or '—' for d in dom)} |")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
