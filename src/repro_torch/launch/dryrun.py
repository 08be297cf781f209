"""The dry run: price one rank of every (arch x shape x mesh) cell on the
production meshes (the JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell's step on 256 or 512
simulated devices and reads XLA's memory and cost analysis.  The port
traces **one rank** of the production world instead, on the ``meta``
device: shapes only, nothing allocated, nothing computed.  For each cell
:func:`run_cell`

* joins a dry world of the mesh's ranks as the rank to price
  (:func:`repro_torch.distributed.world.init_dry_world`: a fake process
  group, whose collectives move nothing and are counted as on a real
  world), and builds that rank's parameters through the port's own init
  (:class:`~repro_torch.models.common.MetaDraws`), its optimizer state
  for a train cell (:func:`opt_config_for`: the factored state from 60e9
  parameters, as the reference), its cache for a decode cell (the
  encoder's ``enc_len`` as the reference's), and the cell's inputs
  (:mod:`repro_torch.configs.shapes`: the global batch, of which the
  train step takes the rank's rows; a prefill or decode rank's rows of
  it, the whole batch where the data axis does not divide it);
* traces the step (``build_train_step``: forward, backward and the AdamW
  update; ``build_prefill_step``; ``build_serve_step`` at the cache's
  last position) under :func:`~.hlo_cost.analyze`: FLOPs, bytes, the
  collectives by axis and op, the peak of live storage, K4's work as its
  wrapper records it on ``meta``;
* prices ceil blocks: where the model axis does not divide a dim, ranks
  differ (deepseek-coder-33b's ranks 14-15 hold no heads at ``M = 16``),
  so model rank 0 and the last model rank are traced and recorded, and
  the terms are the larger of the two;
* prices a prefill or decode cell from shallow copies of the stack
  (:func:`depths`): the layers of a stack run the same ops, so a cost is
  ``base + sum_v n_v a_v`` over the stack's counts ``n_v`` (its layers;
  the encoder's; the hybrid's shared-block calls), and three traces at
  two or three layers give ``base`` and each ``a_v`` (:func:`_weights`).
  Torch's meta kernels are mostly Python (~60 us an op here), and a 32k
  prefill makes ~10^4 ops a layer in ``blockwise_attn``'s loops, so a
  full-depth trace takes minutes a rank.  FLOPs, bytes, collectives and
  K4's work come out as the full-depth trace's (held by the tests); the
  peak is extrapolated alike, which holds where the peak sits in the
  same place at every depth.  A train cell is traced at full depth: its
  ZeRO-1 cut picks a dim by whether ``D`` divides the layers, so its
  optimizer's traffic is not linear in them.  ``exact=True`` traces
  every cell at full depth.

``memory.argument_bytes`` (params, optimizer state, cache and the rank's
rows) is exact; ``memory.peak_bytes`` is the high-water mark of live
storage over the traced step: an estimate of the eager step's peak, not
a compiler's.  The roofline ``terms`` use one NVIDIA H100 SXM's data-sheet
constants at its 700 W limit (:data:`HW`): the FLOPs over the dense bf16
peak, the bytes over HBM3's rate, and each axis's collective bytes over
its link: NVLink 4 within a node of 8 cards, the network across nodes
(an axis whose ranks span two nodes, as a model axis of 16 does, or a
data axis with the model axis between its ranks, takes the network's).
There are no reference figures to hold them to: the reference's own dry
run does not run (ROADMAP.md, Queue 3).  ``model_flops`` is the
reference's 6 N D formula.

``python -m repro_torch.launch.dryrun --arch granite-20b --shape
train_4k`` prices one cell; ``--all --both-meshes`` every cell on both
meshes.  Records go to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>
.json``; a failing cell is recorded ``"status": "fail"`` and makes the
run exit 1; a skipped cell carries ``configs/shapes.applicable``'s
reason.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from fractions import Fraction
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.shapes import (SHAPES, ShapeCell, applicable,
                                        input_specs)
from repro_torch.distributed import close_world
from repro_torch.distributed.world import init_dry_world
from repro_torch.launch.hlo_cost import analyze
from repro_torch.launch.mesh import mesh_name, production_mesh
from repro_torch.models import build_model
from repro_torch.models.common import ModelConfig, tree_leaves
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train import (build_prefill_step, build_serve_step,
                               build_train_step)

# one NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data sheet
HW = {"card": "NVIDIA H100 SXM 80GB HBM3, 700 W",
      "peak_flops": 989.4e12,       # dense bf16
      "hbm_gbs": 3.35e12,           # HBM3
      "nvlink_gbs": 450e9,          # NVLink 4, one direction, within a node
      "net_gbs": 50e9,              # 400 Gb/s NDR a card, across nodes
      "node_cards": 8}
META = torch.device("meta")


def opt_config_for(cfg: ModelConfig) -> OptConfig:
    """The reference's: the factored state from 60e9 parameters up."""
    big = cfg.params_count() >= 60e9
    return OptConfig(factored=big, master_fp32=not big)


def model_flops(cfg: ModelConfig, shape: ShapeCell) -> float:
    """The reference's 6 N D (train) or 2 N D (prefill, decode) FLOPs of
    the cell, N the non-embedding parameters (the MoE's experts counted at
    ``top_k / n_experts``), D the tokens."""
    n = cfg.params_count()
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n_nonemb = n - emb
    if cfg.family == "moe":
        gated = 3 if cfg.act in ("swiglu", "geglu") else 2
        expert_p = (cfg.n_layers * cfg.n_experts * gated * cfg.d_model
                    * cfg.d_ff)
        n_active = n_nonemb - expert_p + expert_p * (cfg.top_k
                                                     / cfg.n_experts)
    else:
        n_active = n_nonemb
    tokens = shape.batch * (shape.seq if shape.kind in ("train", "prefill")
                            else 1)
    return (6 if shape.kind == "train" else 2) * n_active * tokens


def link(ranks) -> str:
    """``"nvlink"`` where an axis's ranks sit in one node of
    ``HW["node_cards"]`` consecutive ranks, else ``"net"``."""
    return "nvlink" if len({r // HW["node_cards"] for r in ranks}) == 1 \
        else "net"


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _inputs(cfg: ModelConfig, shape: ShapeCell, rows: int) -> dict:
    """The cell's inputs on ``meta``, ``rows`` rows of each."""
    return {name: torch.empty((rows,) + tuple(shp[1:]), dtype=dtype,
                              device=META)
            for name, (shp, dtype) in input_specs(cfg, shape).items()}


def _step(cfg: ModelConfig, shape: ShapeCell, world, rows: int,
          trace: bool) -> Dict[str, Any]:
    """One rank's state on ``meta`` and, with ``trace``, its step's costs
    (:func:`~.hlo_cost.analyze`): ``param_bytes``, ``argument_bytes``."""
    model = build_model(cfg, world)
    params = model.init(0, device=META)
    if shape.kind == "train":
        opt = opt_config_for(cfg)
        state = adamw_init(params, opt, world,
                           None if world is None else model.places(params))
        args = (build_train_step(model, opt), params, state,
                _inputs(cfg, shape, shape.batch))
        argument = _nbytes(params) + _nbytes(state) + \
            _nbytes(_inputs(cfg, shape, rows))
    elif shape.kind == "prefill":
        batch = _inputs(cfg, shape, rows)
        args = (build_prefill_step(model), params, batch)
        argument = _nbytes(params) + _nbytes(batch)
    else:
        enc_len = max(cfg.frontend_len, 1024) if cfg.enc_layers else 0
        cache = model.init_cache(rows, shape.seq, enc_len=enc_len,
                                 device=META)
        cache["pos"] = shape.seq - 1
        tokens = _inputs(cfg, shape, rows)["tokens"]
        args = (build_serve_step(model), params, cache, tokens)
        argument = _nbytes(params) + _nbytes(cache) + _nbytes(tokens)
    out = dict(param_bytes=_nbytes(params), argument_bytes=argument)
    if trace:
        cost = analyze(*args)
        cost.pop("result")
        cost.pop("argument_bytes")
        out.update(cost)
    return out


def depths(cfg: ModelConfig) -> Tuple[Dict[str, int], list, Any]:
    """The counts of ``cfg``'s stack (module doc), the shallow points to
    trace, and the config of given counts: ``layers``; the enc-dec's
    ``enc`` layers; the hybrid's ``shared`` block calls (after every
    ``layers // shared``-th mamba block)."""
    full = {"layers": cfg.n_layers}
    points = [{"layers": 2}, {"layers": 3}]
    if cfg.enc_layers:
        full["enc"] = cfg.enc_layers
        points = [{"layers": 2, "enc": 2}, {"layers": 3, "enc": 2},
                  {"layers": 3, "enc": 3}]
    if cfg.family == "hybrid" and cfg.shared_every:
        full["shared"] = cfg.n_layers // cfg.shared_every
        points = [{"layers": 2, "shared": 1}, {"layers": 3, "shared": 1},
                  {"layers": 4, "shared": 2}]

    def make(n):
        kw = dict(n_layers=n["layers"])
        if "enc" in n:
            kw["enc_layers"] = n["enc"]
        if "shared" in n:
            kw["shared_every"] = n["layers"] // n["shared"]
        return dataclasses.replace(cfg, **kw)

    return full, points, make


def _weights(full: Dict[str, int], points: list) -> list:
    """``w`` with ``sum_i w_i c(points[i])`` the cost at ``full`` for a
    cost ``base + sum_v n_v a_v``: the solution of ``[1, n_v(p_i)]^T w =
    [1, full_v]``, in exact fractions."""
    keys = list(full)
    n = len(points)
    # rows: the constant, then each count; columns: the points
    a = [[Fraction(1)] * n] + [[Fraction(p[k]) for p in points]
                               for k in keys]
    b = [Fraction(1)] + [Fraction(full[k]) for k in keys]
    for c in range(n):                         # Gauss-Jordan
        piv = next(r for r in range(c, n) if a[r][c] != 0)
        a[c], a[piv], b[c], b[piv] = a[piv], a[c], b[piv], b[c]
        for r in range(n):
            if r != c and a[r][c] != 0:
                f = a[r][c] / a[c][c]
                a[r] = [x - f * y for x, y in zip(a[r], a[c])]
                b[r] -= f * b[c]
    return [b[i] / a[i][i] for i in range(n)]


def _combine(parts, weights) -> Dict[str, Any]:
    """``sum_i weights[i] * parts[i]`` over every number of the costs:
    the totals, and the collectives' and the kernels' calls and bytes."""
    flat: Dict[tuple, float] = {}
    for part, w in zip(parts, weights):
        rows = [((k,), part[k]) for k in ("flops", "bytes", "peak_bytes",
                                          "output_bytes")]
        rows += [(("bytes_by_op", op), v)
                 for op, v in part["bytes_by_op"].items()]
        rows += [(("collective_detail", a, op, f), v)
                 for a, ops in part["collective_detail"].items()
                 for op, c in ops.items() for f, v in c.items()]
        rows += [(("kernels", name, f), v)
                 for name, c in part["kernels"].items() for f, v in c.items()]
        for key, v in rows:
            flat[key] = flat.get(key, 0) + w * int(v)
    out: Dict[str, Any] = {"collective_detail": {}, "kernels": {},
                           "bytes_by_op": {}}
    for key, v in flat.items():
        node = out
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = int(round(v))
    out["flops"] = float(out["flops"])
    out["bytes"] = float(out["bytes"])
    out["collective_bytes"] = float(sum(
        c["bytes"] for ops in out["collective_detail"].values()
        for c in ops.values()))
    out["unknown_while"] = 0
    return out


def trace_rank(cfg: ModelConfig, shape: ShapeCell, mesh: Tuple[int, int],
               rank: int = 0, exact: bool = False) -> Dict[str, Any]:
    """One rank of ``mesh`` on ``meta`` (module doc): its step's costs
    (:func:`~.hlo_cost.analyze`; extrapolated from shallow stacks unless
    ``exact``), its parameter and argument bytes (exact), the links of
    its axes.  At ``(1, 1)`` the model is built with no world, as one
    device runs it."""
    d, m = mesh
    world = None if mesh == (1, 1) else init_dry_world(rank, mesh)
    try:
        t0 = time.perf_counter()
        B = shape.batch
        rows = B // d if B % d == 0 else B
        links = {} if world is None else {
            "data": link(world.data.ranks), "model": link(world.model.ranks),
            "world": link(range(world.size))}
        full, points, make = depths(cfg)
        shallow = not exact and shape.kind != "train" and \
            full["layers"] > max(p["layers"] for p in points)
        rec = _step(cfg, shape, world, rows, trace=not shallow)
        if shallow:
            parts = [_step(make(n), shape, world, rows, True)
                     for n in points]
            rec.update(_combine(parts, _weights(full, points)))
        return dict(rec, rank=rank, model_rank=rank % m, rows=rows,
                    links=links, extrapolated=shallow,
                    trace_s=time.perf_counter() - t0)
    finally:
        if world is not None:
            close_world()


def terms(rec: Dict[str, Any]) -> Dict[str, float]:
    """The roofline terms of one traced rank, in seconds (module doc)."""
    coll = sum(c["bytes"] / HW[f"{rec['links'].get(axis, 'net')}_gbs"]
               for axis, ops in rec["collective_detail"].items()
               for c in ops.values())
    return {"compute_s": rec["flops"] / HW["peak_flops"],
            "memory_s": rec["bytes"] / HW["hbm_gbs"],
            "collective_s": coll}


def price(cfg: ModelConfig, shape: ShapeCell, mesh: Tuple[int, int],
          exact: bool = False) -> Dict[str, Any]:
    """Model rank 0 and the last model rank of data group 0, traced
    (module doc): ``{"ranks": [...], "terms": ..., "dominant": ...}``,
    the terms each the larger rank's."""
    m = mesh[1]
    ranks = [trace_rank(cfg, shape, mesh, r, exact)
             for r in ((0, m - 1) if m > 1 else (0,))]
    t = [terms(r) for r in ranks]
    top = {k: max(x[k] for x in t) for k in t[0]}
    for r, x in zip(ranks, t):
        r["terms"] = x
    return {"ranks": ranks, "terms": top, "dominant": max(top, key=top.get)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = "experiments/dryrun_torch",
             cfg_overrides: Optional[Dict[str, Any]] = None,
             tag: str = "", *, mesh: Optional[Tuple[int, int]] = None,
             smoke: bool = False) -> Dict[str, Any]:
    """Price one cell on the production mesh (module doc) and write its
    record to ``out_dir`` (none where ``out_dir`` is empty); returns the
    record, with the reference's keys.  ``mesh`` and ``smoke`` (not the
    reference's): another mesh ``(D, M)``, the SMOKE config."""
    mesh = mesh or production_mesh(multi_pod)
    cfg = get_config(arch, smoke=smoke, **(cfg_overrides or {}))
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    name = mesh_name(multi_pod) if mesh == production_mesh(multi_pod) \
        else f"{mesh[0]}x{mesh[1]}"
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": name,
                           "kind": shape.kind, "tag": tag}
    if not ok:
        rec.update(status="skip", reason=why)
        return rec
    priced = price(cfg, shape, mesh)
    ranks = priced["ranks"]
    top = max(ranks, key=lambda r: max(r["terms"].values()))
    by_op: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for ops in top["collective_detail"].values():
        for op, c in ops.items():
            by_op[op] = by_op.get(op, 0) + c["bytes"]
            calls[op] = calls.get(op, 0) + c["calls"]
    rec.update({
        "status": "ok",
        "lower_s": 0.0,
        "compile_s": sum(r["trace_s"] for r in ranks),
        "devices": mesh[0] * mesh[1],
        "mesh_shape": list(mesh),
        "flops_total": top["flops"],
        "bytes_total": top["bytes"],
        "model_flops": model_flops(cfg, shape),
        "collectives": dict(by_op, counts=calls),
        "unknown_while": 0,
        "collective_top": sorted(by_op.items(), key=lambda kv: -kv[1]),
        # no XLA here: the aten counts of the rank whose terms are larger
        "xla_cost_raw": {"flops": top["flops"], "bytes": top["bytes"]},
        "memory": {"argument_bytes": top["argument_bytes"],
                   "output_bytes": top["output_bytes"],
                   "temp_bytes": top["peak_bytes"] - top["argument_bytes"],
                   "peak_bytes": top["peak_bytes"],
                   "peak_is": "estimate: live storage high-water of the "
                              "eager step"},
        "params": cfg.params_count(),
        "terms": priced["terms"],
        "dominant": priced["dominant"],
        "hw": HW,
        "ranks": ranks,
    })
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{arch}__{shape_name}__{rec['mesh']}"
        if tag:
            name += f"__{tag}"
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(rec, f, indent=2, default=float)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_NAMES + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--opt", default="",
                    help="comma list: attn,moe,kv -> optimization flags")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    overrides = {}
    if "attn" in args.opt:
        overrides["opt_attn_layout"] = True
    if "moe" in args.opt:
        overrides["opt_moe_dispatch"] = True
    if "kv" in args.opt:
        overrides["opt_kv_quant"] = True

    archs = ARCH_NAMES if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = run_cell(arch, shape, mp, args.out,
                                   cfg_overrides=overrides, tag=args.tag)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": mesh_name(mp), "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                if rec["status"] == "ok":
                    m = rec["memory"]
                    print(f"[{rec['mesh']}] {arch:28s} {shape:12s} OK "
                          f"trace={rec['compile_s']:6.1f}s "
                          f"peak/rank={m['peak_bytes'] / 2**30:7.2f}GiB "
                          f"dominant={rec['dominant']}", flush=True)
                elif rec["status"] == "skip":
                    print(f"[{rec['mesh']}] {arch:28s} {shape:12s} SKIP "
                          f"({rec['reason']})", flush=True)
                else:
                    print(f"[{rec['mesh']}] {arch:28s} {shape:12s} FAIL "
                          f"{rec['error']}", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
