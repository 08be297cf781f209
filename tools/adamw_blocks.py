"""Peak memory and time of one AdamW update by how its leaves are blocked.

    python tools/adamw_blocks.py [--card] [--cpu]

``--card``: on the card, mamba2-2.7b FULL (bf16 weights, fp32 masters, the
launcher's optimizer) and dbrx-132b at full width cut to one layer (bf16,
the factored state): one ``adamw_update`` with each leaf a slab at a time
(``adamw.SLAB``, as the port runs) against each leaf whole.  Printed per
run: the device bytes above the live trees at the peak
(``torch.cuda.max_memory_allocated``) and the wall; an out-of-memory error
is printed as such.

``--cpu``: on the host, the two fp32 cuts of ``chip_smoke``'s train gate
(dbrx-132b's one layer, factored; mamba2-2.7b's two layers, masters):
blocks of ``adamw.CPU_BLOCK`` (as the port runs) against the card's
``SLAB``, each with the factored leaves' slab temporaries reused from slab
to slab (``adamw._work``, as the port runs) and allocated afresh.  Printed
per run: the seconds and the rise of the process's resident set at its
peak (sampled every 10 ms).

Weights and gradients are drawn on the card from a seed (the CPU runs copy
them to the host).  Needs a CUDA card; one JSON line per run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]

import torch  # noqa: E402

WHOLE = 1 << 62


def _setup(arch: str, cuts: dict, device: str):
    """(config, params, grads, optimizer config) of ``arch`` cut to
    ``cuts``, drawn on the card and moved to ``device``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import opt_config_for
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    cfg = get_config(arch, **cuts)
    params = build_model(cfg).init(0)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def grad(p):
        return (torch.randn(p.shape, generator=gen, device=p.device,
                            dtype=torch.float32) * 1e-2).to(p.dtype)
    grads = tree_map(grad, params)
    if device != "cuda":
        params = tree_map(lambda t: t.to(device), params)
        grads = tree_map(lambda t: t.to(device), grads)
        torch.cuda.empty_cache()
    opt = dataclasses.replace(opt_config_for(get_config(arch), 1), warmup=1)
    return cfg, params, grads, opt


class _PeakRss:
    """The process's resident set sampled every 10 ms while open:
    ``base`` at entry, ``peak`` the largest sample."""

    def __enter__(self):
        self.base = self.peak = _status("VmRSS")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, _status("VmRSS"))

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _status("VmRSS"))


def _status(key: str) -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise KeyError(key)


def card_runs() -> None:
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw, adamw_init
    for arch, cuts in (("mamba2-2.7b", {}),
                       ("dbrx-132b", dict(n_layers=1))):
        cfg, params, grads, opt = _setup(arch, cuts, "cuda")
        state = adamw_init(params, opt)
        largest = max(p.numel() for p in tree_leaves(params))
        for name, slab in (("slab", adamw.SLAB), ("slab", adamw.SLAB),
                           ("whole leaf", WHOLE)):
            keep = adamw.SLAB
            adamw.SLAB = slab
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            try:
                adamw.adamw_update(params, grads, state, opt)
                torch.cuda.synchronize()
                err = None
            except torch.cuda.OutOfMemoryError as e:
                err = str(e).split("\n")[0]
            wall = time.perf_counter() - t0
            adamw.SLAB = keep
            print(json.dumps(dict(
                where="card", arch=cfg.name, cuts=cuts, dtype=cfg.dtype,
                factored=opt.factored, blocking=name, slab_elements=slab,
                largest_leaf_elements=largest, live_trees_bytes=base,
                peak_above_live_bytes=torch.cuda.max_memory_allocated()
                - base, wall_s=wall, out_of_memory=err)), flush=True)
            torch.cuda.empty_cache()
        del params, grads, state
        torch.cuda.empty_cache()


def _fresh(work, i, like):
    return torch.empty(like.shape, dtype=torch.float32, device=like.device)


def cpu_runs() -> None:
    from repro_torch.optim import adamw, adamw_init
    reuse = adamw._work
    for arch, cuts in (("dbrx-132b", dict(n_layers=1, dtype="float32")),
                       ("mamba2-2.7b", dict(n_layers=2, dtype="float32"))):
        cfg, params, grads, opt = _setup(arch, cuts, "cpu")
        state = adamw_init(params, opt)
        for block, work in ((adamw.CPU_BLOCK, "reused"),
                            (adamw.CPU_BLOCK, "fresh"),
                            (adamw.SLAB, "reused"), (adamw.SLAB, "fresh")):
            keep = adamw.CPU_BLOCK
            adamw.CPU_BLOCK = block
            adamw._work = reuse if work == "reused" else _fresh
            with _PeakRss() as rss:
                t0 = time.perf_counter()
                adamw.adamw_update(params, grads, state, opt)
                wall = time.perf_counter() - t0
            adamw.CPU_BLOCK, adamw._work = keep, reuse
            print(json.dumps(dict(
                where="cpu", arch=cfg.name, cuts=cuts, factored=opt.factored,
                block_elements=block, workspaces=work,
                threads=torch.get_num_threads(), seconds=wall,
                peak_rss_rise_bytes=rss.peak - rss.base,
                rss_bytes=rss.base)), flush=True)
        del params, grads, state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--card", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("adamw_blocks: needs a CUDA card", file=sys.stderr)
        return 2
    if args.card or not args.cpu:
        card_runs()
    if args.cpu or not args.card:
        cpu_runs()
    return 0


if __name__ == "__main__":
    sys.exit(main())
