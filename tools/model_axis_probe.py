"""Where ``chip_smoke.py`` phase 5d's, 5e's and 5f's time goes, on the
card, and the model axis at the reference's production width.

    python tools/model_axis_probe.py phase
    python tools/model_axis_probe.py families
    python tools/model_axis_probe.py uneven
    python tools/model_axis_probe.py heads16
    python tools/model_axis_probe.py bf16-floor
    python tools/model_axis_probe.py collectives
    python tools/model_axis_probe.py save
    python tools/model_axis_probe.py first-step

* ``phase``: phase 5d alone: a gloo world of 2 remeshed as 1 x 2 runs
  ``chip_smoke.axis_serve_rank``, one of 4 remeshed as 2 x 2
  ``chip_smoke.train_rank``, then ``chip_smoke.model_axis_phase``
  checks them; prints each world's seconds and the phase's;
* ``families``: phase 5e alone, the same way: ``chip_smoke.
  family_references`` on one device, then the worlds' ranks (fresh
  processes: their first steps cost what 5c's and 5d's work pays in the
  script) and ``chip_smoke.family_axis_phase``;
* ``uneven``: phase 5f alone (``chip_smoke.uneven_phase``: one device's
  side, a world of 1 x 3 ranks, the checks, K4 at rank 0's heads);
* ``heads16``: deepseek-coder-33b FULL at depth 1 over a gloo world of 1 x
  16 ranks sharing the card, the model axis of the reference's production
  mesh (56 heads in blocks of 4, ranks 14 and 15 with none; the 8 K/V
  heads replicated; ``attn_impl="pallas"``, FULL's sequence
  parallelism): the prefill B=1 x 4096 (after a warm one) held to one
  device's within ``chip_smoke.LOGIT_GAP_TOL``, which a control with the
  layer's attention zeroed must exceed; K4's launches a rank; the wall,
  each rank's heads, parameter and peak bytes; and each rank's parameter
  bytes at the full 62 layers from ``leaf_place``'s cuts, beside an even
  share (the whole tree's bytes / 16);
* ``bf16-floor``: what bf16 alone moves on one device, for phase 5e's
  gates: each of ``chip_smoke.AXIS_FAMILIES`` at its cut, the prefill's
  last logits and ``AXIS_DECODE`` decode steps (teacher-forced on the
  bf16 run's greedy tokens) in bf16 against the same weights in fp32
  (the bf16 weights are the fp32 draw rounded), as ``logit_gap`` reads
  them;
* ``collectives``: a gloo world of 2 sharing the card, ``all_gather`` and
  ``reduce_scatter_sum`` of 1 GB and 512 MB fp32 card tensors, three calls
  each (the first call at a size against the later ones), once as the
  process starts and once with ``PYTORCH_CUDA_ALLOC_CONF=pinned_use_cuda_
  host_register:True,pinned_num_register_threads:8`` in the ranks'
  environment;
* ``save``: ``chip_smoke.train_rank`` over 2 x 2 with the checkpoint's
  gathers and writes timed apart;
* ``first-step``: the 2 x 2 fp32 gate's first three steps, the first under
  ``torch.profiler`` on rank 0 (its 25 most expensive entries by self CPU
  time).

Each prints the card's name and power limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

HOST_REGISTER = ("pinned_use_cuda_host_register:True,"
                 "pinned_num_register_threads:8")


def phase_rank(world, ckpt: str):
    """One rank of ``phase``: its part of phase 5d, timed."""
    import chip_smoke as cs
    t0 = time.perf_counter()
    if world.size == 2:
        out = cs.axis_serve_rank(world.remesh((1, 2)))
    else:
        out = cs.train_rank(world.remesh((2, 2)), ckpt, cs.AXIS_GATE_RUN,
                            cs.AXIS_BF16_RUN)
    return out, time.perf_counter() - t0


def families_rank(world, refs: dict, ckpt: str):
    """One rank of ``families``: its part of phase 5e, timed."""
    import chip_smoke as cs
    t0 = time.perf_counter()
    if world.size == 2:
        out = cs.family_serve_rank(world.remesh((1, 2)), refs)
    else:
        out = cs.train_rank(world.remesh((2, 2)), ckpt,
                            cs.AXIS_FAMILY_GATE, cs.AXIS_FAMILY_BF16)
    return out, time.perf_counter() - t0


HEADS16 = ("deepseek-coder-33b", dict(n_layers=1, attn_impl="pallas"),
           (1, 4096))
HEADS16_MESH = (1, 16)


def heads16_rank(world, tokens):
    """One rank of ``heads16``: the prefill of ``tokens`` over the world's
    model axis (after a warm one; K4's counts set to 0 just before, read
    just after), its heads, K/V heads, parameter and peak bytes."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import build_prefill_step
    cs.use_src()
    arch, cuts, _ = HEADS16
    cfg = get_config(arch, **cuts)
    model = build_model(cfg, world)
    params, init_s, _ = cs.timed(lambda: model.init(cs.LM_SEED))
    batch = {"tokens": tokens.to(world.device)}
    prefill = build_prefill_step(model)
    prefill(params, batch)                             # warm
    torch.cuda.synchronize()
    reset_launches()
    logits, wall, peak = cs.timed(lambda: prefill(params, batch))
    return dict(logits=logits[..., :cfg.vocab].cpu(), prefill_s=wall,
                peak_bytes=peak, init_s=init_s, launches=dict(LAUNCHES),
                heads=model.par.head_range(cfg),
                kv_heads=model.par.kv_range(cfg),
                param_bytes=sum(t.numel() * t.element_size()
                                for t in tree_leaves(params)))


def rank_param_bytes(cfg, params, mesh, layers: int) -> list:
    """Each model rank's parameter bytes of ``cfg`` at ``layers`` layers
    from ``leaf_place``'s cuts of ``params`` (a whole tree of ``cfg``,
    its stacked leaves counted ``layers`` times a layer)."""
    import math

    from repro_torch.models.common import (axis_range, leaf_place,
                                           tree_map_paths)
    leaves = []
    tree_map_paths(lambda p, t: leaves.append((p, t)), params)
    out = []
    for mi in range(mesh[1]):
        total = 0
        for path, t in leaves:
            shape = list(t.shape)
            for dim, axis, whole, block in leaf_place(path, cfg, mesh).cuts:
                lo, hi = axis_range(whole, block, 0 if axis == "data"
                                    else mi)
                shape[dim] = hi - lo
            n = math.prod(shape) * t.element_size()
            if path[0] in ("layers", "enc"):
                n = n // t.shape[0] * layers
            total += n
        out.append(total)
    return out


def heads16() -> dict:
    """``heads16`` (module doc)."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.distributed import run_world
    from repro_torch.models import build_model
    from repro_torch.train import build_prefill_step
    arch, cuts, (B, S) = HEADS16
    cfg = get_config(arch, **cuts)
    model = build_model(cfg)
    params = model.init(cs.LM_SEED)
    tokens = cs.axis_tokens(cfg, B, S)
    batch = {"tokens": tokens.to(cs.CARD)}
    prefill = build_prefill_step(model)
    prefill(params, batch)                             # warm
    want, one_s, one_peak = cs.timed(lambda: prefill(params, batch))
    want = want[..., :cfg.vocab]
    control = cs.with_attention(cs.skip_attention(0), lambda: prefill(
        params, batch))[..., :cfg.vocab]
    full = get_config(arch)
    per_rank = rank_param_bytes(cfg, params, HEADS16_MESH, full.n_layers)
    whole = rank_param_bytes(cfg, params, (1, 1), full.n_layers)[0]
    del model, params, batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_world(heads16_rank, HEADS16_MESH[0] * HEADS16_MESH[1],
                      tokens, mesh=HEADS16_MESH, timeout=900)
    world_s = time.perf_counter() - t0
    gap = cs.logit_gap(ranks[0]["logits"].to(cs.CARD), want)
    control_gap = cs.logit_gap(control, want)
    k4 = [r["launches"]["flash_attention"] for r in ranks]
    out = dict(arch=cfg.name, layers=cfg.n_layers,
               mesh=f"{HEADS16_MESH[0]}x{HEADS16_MESH[1]}",
               backend="gloo", batch=B, seq=S, logits_gap=gap,
               control_gap=control_gap, gate=cs.LOGIT_GAP_TOL,
               world_s=world_s, prefill_s=[r["prefill_s"] for r in ranks],
               one_device_prefill_s=one_s,
               peak_bytes_by_rank=[r["peak_bytes"] for r in ranks],
               one_device_peak_bytes=one_peak,
               init_s=[r["init_s"] for r in ranks],
               heads_by_rank=[r["heads"] for r in ranks],
               kv_heads_by_rank=[r["kv_heads"] for r in ranks],
               param_bytes_by_rank=[r["param_bytes"] for r in ranks],
               k4_launches_by_rank=k4,
               full_depth_param_bytes_by_rank=per_rank,
               full_depth_even_share=whole / HEADS16_MESH[1],
               full_depth_busiest_over_even=max(per_rank)
               / (whole / HEADS16_MESH[1]))
    print(json.dumps(out), flush=True)
    ok = (gap <= cs.LOGIT_GAP_TOL < control_gap and all(
        torch.equal(r["logits"], ranks[0]["logits"]) for r in ranks)
        and all(n == (cfg.n_layers if r["heads"][1] > r["heads"][0] else 0)
                for n, r in zip(k4, ranks)))
    print("heads16:", "ok" if ok else "FAILED", flush=True)
    out["ok"] = ok
    return out


def bf16_floor() -> list:
    """Each 5e model's bf16 logits gaps against its fp32 run (module
    doc)."""
    import dataclasses

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import build_prefill_step, build_serve_step
    rows = []
    for arch, cuts, (B, S) in cs.AXIS_FAMILIES:
        cfg = get_config(arch, **dict(cuts, attn_impl="xla"))
        runs = {}
        toks = None
        for dtype in ("bfloat16", "float32"):
            model = build_model(dataclasses.replace(cfg, dtype=dtype))
            params = model.init(cs.LM_SEED)
            batch = {"tokens": cs.axis_tokens(cfg, B, S).to(cs.CARD)}
            logits = build_prefill_step(model)(params, batch)[..., :cfg.vocab]
            if toks is None:
                toks = [logits[:, -1:].argmax(-1)]
            serve = build_serve_step(model)
            cache = model.init_cache(B, cs.AXIS_DECODE)
            steps = []
            for t in range(cs.AXIS_DECODE):
                lg, cache = serve(params, cache, toks[t])
                steps.append(lg[..., :cfg.vocab])
                if len(toks) < cs.AXIS_DECODE:
                    toks.append(lg[:, -1:, :cfg.vocab].argmax(-1))
            runs[dtype] = (logits, steps)
            del model, params, cache
            torch.cuda.empty_cache()
        (lb, sb), (lf, sf) = runs["bfloat16"], runs["float32"]
        rows.append(dict(arch=cfg.name, layers=cfg.n_layers,
                         prefill_gap=cs.logit_gap(lb, lf),
                         decode_gaps=[cs.logit_gap(a, b)
                                      for a, b in zip(sb, sf)]))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def collectives_rank(world) -> dict:
    """Seconds of each gather and reduce-scatter, by size and call."""
    import torch
    from repro_torch.distributed import all_gather, reduce_scatter_sum
    out = {}
    for n in (1 << 28, 1 << 27):
        x = torch.ones(n // world.size, device=world.device)
        y = torch.ones(n, device=world.device)
        for i in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            all_gather(x, 0, world)
            torch.cuda.synchronize()
            out[f"all_gather {4 * n} B, call {i}"] = time.perf_counter() - t
            t = time.perf_counter()
            reduce_scatter_sum(y, 0, world)
            torch.cuda.synchronize()
            out[f"reduce_scatter {4 * n} B, call {i}"] = \
                time.perf_counter() - t
    return out


def save_rank(world, ckpt: str) -> dict:
    """Phase 5d's ``train_rank`` over 2 x 2, its save's gathers and writes
    timed apart."""
    import chip_smoke as cs
    import repro_torch.ckpt.checkpoint as ck
    acc = collections.defaultdict(float)

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[name] += time.perf_counter() - t
        return run

    ck.gather_cuts = timed("gathers_s", ck.gather_cuts)
    ck._save_leaf = timed("writes_s", ck._save_leaf)
    out = cs.train_rank(world.remesh((2, 2)), ckpt, cs.AXIS_GATE_RUN,
                        cs.AXIS_BF16_RUN)
    return dict(save_s=out["gate"]["save_s"], **acc)


def first_step_rank(world) -> dict:
    """The fp32 gate's first three steps; the first profiled on rank 0."""
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    world = world.remesh((2, 2))
    arch, cuts, (B, S, _) = cs.AXIS_GATE_RUN
    cfg = get_config(arch, **cuts)
    model = build_model(cfg, world)
    params = model.init(cs.TRAIN_SEED)
    opt = cs.gate_opt(arch)
    state = adamw_init(params, opt, world, model.places(params))
    step = build_train_step(model, opt)
    out = {}
    for s in range(3):
        b = cs.train_batch(cfg, B, S, s, device=world.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if s == 0 and world.rank == 0:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU]) as prof:
                params, state, _ = step(params, state, b)
                torch.cuda.synchronize()
            rows = sorted(prof.key_averages(),
                          key=lambda e: -e.self_cpu_time_total)[:25]
            out["top"] = [(e.key[:60], e.self_cpu_time_total / 1e6, e.count)
                          for e in rows]
        else:
            params, state, _ = step(params, state, b)
            torch.cuda.synchronize()
        out[f"step {s} s"] = time.perf_counter() - t
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("phase", "families", "uneven",
                                     "heads16", "bf16-floor", "collectives",
                                     "save", "first-step"))
    args = ap.parse_args()
    import chip_smoke as cs
    from repro_torch.distributed import run_world
    from repro_torch.kernels._build import load_library
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    ckpt = os.path.join(HERE, "build", "model_axis_probe_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        if args.what == "phase":
            load_library("flash_attention")
            t0 = time.perf_counter()
            axis = {}
            for size in (2, 4):
                t = time.perf_counter()
                got = run_world(phase_rank, size, ckpt, timeout=600)
                axis[size] = [r[0] for r in got]
                print(f"world of {size}: {time.perf_counter() - t:.1f} s, "
                      f"its ranks' part {max(r[1] for r in got):.1f} s",
                      flush=True)
            cs.model_axis_phase(axis, ckpt)
            print(f"phase 5d: {time.perf_counter() - t0:.1f} s", flush=True)
        elif args.what == "families":
            load_library("flash_attention")
            t0 = time.perf_counter()
            refs = cs.family_references()
            print(f"one device's side: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            family = {}
            for size in (2, 4):
                t = time.perf_counter()
                got = run_world(families_rank, size, refs, ckpt,
                                timeout=600)
                family[size] = [r[0] for r in got]
                print(f"world of {size}: {time.perf_counter() - t:.1f} s, "
                      f"its ranks' part {max(r[1] for r in got):.1f} s",
                      flush=True)
            got = cs.family_axis_phase(family, refs, ckpt)
            print(json.dumps(got), flush=True)
            print(f"phase 5e: {time.perf_counter() - t0:.1f} s", flush=True)
        elif args.what == "uneven":
            load_library("flash_attention")
            t0 = time.perf_counter()
            print(json.dumps(cs.uneven_phase()), flush=True)
            print(f"phase 5f: {time.perf_counter() - t0:.1f} s", flush=True)
        elif args.what == "heads16":
            load_library("flash_attention")
            if not heads16()["ok"]:
                return 1
        elif args.what == "bf16-floor":
            bf16_floor()
        elif args.what == "collectives":
            for env in (None, HOST_REGISTER):
                if env:
                    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
                got = run_world(collectives_rank, 2, timeout=300)
                print(json.dumps(dict(alloc_conf=env, **got[0])), flush=True)
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        elif args.what == "save":
            got = run_world(save_rank, 4, ckpt, timeout=600)
            print(json.dumps(got[0]), flush=True)
        else:
            got = run_world(first_step_rank, 4, timeout=600)
            for r in got:
                print(json.dumps({k: v for k, v in r.items()
                                  if k != "top"}), flush=True)
            for row in got[0]["top"]:
                print(row, flush=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
