"""The dry run (``repro_torch.launch.{mesh,hlo_cost,dryrun}``): one rank of
a production world traced on the ``meta`` device.

* ``hlo_cost``: the JAX package's ``tests/test_hlo_cost.py`` cases as
  torch programs (one matmul, 8 layers in a loop, nested loops, a batched
  einsum, bytes that grow with the loop), a backward at 3x the forward,
  a dry world's collectives counted by axis and op, K4's work on
  ``meta``, the peak of live storage;
* ``model_flops`` equal to the reference's for all ten configs and the
  four shapes (the reference imported in a subprocess: importing its
  ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host devices);
* a rank's parameter bytes under the dry world equal the sum of
  ``leaf_place``'s cuts, for every FULL config at ``(16, 16)`` and
  ``(32, 16)``, model rank 0 and the last;
* dry against real: on SMOKE configs the dry trace's FLOPs, bytes and
  argument bytes equal ``hlo_cost`` over the real CPU step at ``(1,
  1)``; over a 2 x 2 gloo world its collectives (calls and bytes by axis
  and op) and FLOPs equal the real ranks'; the shallow traces'
  extrapolation equals the full-depth trace;
* ``run_cell``: ``ok`` for one SMOKE cell per family at ``(4, 4)``;
  ``long_500k`` skipped for the quadratic configs with the reference's
  reason, on the command line too.

Each dry world lives in this process for one trace and is closed in a
``finally`` (a process has one default group).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import torch_world_ranks as ranks
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable
from repro_torch.distributed import close_world, comm, run_world
from repro_torch.distributed.world import init_dry_world
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import dryrun, mesh
from repro_torch.launch.hlo_cost import analyze
from repro_torch.models import build_model
from repro_torch.models.common import (axis_range, leaf_place,
                                       tree_map_paths)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# -- hlo_cost -----------------------------------------------------------------
def test_single_matmul_flops():
    got = analyze(lambda a, b: a @ b, _meta(128, 256), _meta(256, 512))
    assert got["flops"] == 2 * 128 * 256 * 512
    assert got["unknown_while"] == 0
    assert got["bytes"] == 4 * (128 * 256 + 256 * 512 + 128 * 512)


def test_loop_multiplies_by_trip_count():
    def fn(x, w):
        for wi in w.unbind(0):          # 8 layers
            x = torch.tanh(x @ wi)
        return x

    got = analyze(fn, _meta(32, 64), _meta(8, 64, 64))
    assert got["flops"] == 8 * 2 * 32 * 64 * 64


def test_nested_loops():
    def fn(x, w):
        for wg in w.unbind(0):
            for wi in wg.unbind(0):
                x = x @ wi
        return x

    got = analyze(fn, _meta(16, 32), _meta(4, 3, 32, 32))
    assert got["flops"] == 12 * 2 * 16 * 32 * 32


def test_batched_einsum_flops():
    got = analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                  _meta(4, 64, 96), _meta(4, 96, 32))
    assert got["flops"] == 2 * 4 * 64 * 96 * 32


def test_bytes_scale_with_the_loop():
    def fn(x, w):
        for wi in w.unbind(0):
            x = x @ wi
        return x

    got = analyze(fn, _meta(4, 128), _meta(16, 128, 128))
    # each iteration reads at least its (128, 128) fp32 weight slice
    assert got["bytes"] >= 16 * 128 * 128 * 4


def test_backward_is_twice_the_forward():
    x = _meta(256, 512, dtype=torch.bfloat16).requires_grad_()
    w = _meta(512, 1024, dtype=torch.bfloat16).requires_grad_()

    def fwd_bwd(x, w):
        (x @ w).sum().backward()

    assert analyze(fwd_bwd, x, w)["flops"] == 3 * 2 * 256 * 512 * 1024


def test_peak_counts_live_storage():
    """The arguments, then each op's new storage until torch frees it."""
    def fn(x):
        y = x * 2                     # +4 KiB
        z = y + 1                     # +4 KiB, y freed after
        del y
        return z.sum()

    got = analyze(fn, _meta(1024))
    assert got["argument_bytes"] == 4096
    assert got["peak_bytes"] == 3 * 4096
    assert got["output_bytes"] == 4


def test_dry_world_counts_collectives_by_axis():
    world = init_dry_world(5, (4, 4))
    try:
        assert world.backend == "fake" and world.device == META
        assert (world.data.rank, world.model.rank) == (1, 1)

        def fn(t):
            comm.all_reduce_sum_(t, world.model)
            g = comm.all_gather(t, 0, world.data)
            return comm.reduce_scatter_sum(g, 0, world.data)

        got = analyze(fn, _meta(256, 8))
        n = 256 * 8 * 4
        assert got["collective_detail"] == {
            "model": {"all_reduce": {"calls": 1, "bytes": n}},
            "data": {"all_gather": {"calls": 1, "bytes": n},
                     "reduce_scatter": {"calls": 1, "bytes": 4 * n}}}
        assert got["collective_bytes"] == 6 * n
        assert got["result"].shape == (256, 8)
        with pytest.raises(RuntimeError):
            init_dry_world(0, (4, 4))
    finally:
        close_world()


@pytest.mark.parametrize("causal", (True, False))
def test_flash_attention_on_meta_records_its_work(causal):
    """K4 on ``meta`` computes nothing, returns the output's shape and
    records its FLOPs and bytes (``PERF.md``'s operation count)."""
    B, S, H, KV, hd = 2, 512, 8, 2, 64
    q = _meta(B, S, H, hd, dtype=torch.bfloat16)
    k, v = (_meta(B, S, KV, hd, dtype=torch.bfloat16) for _ in range(2))
    got = analyze(lambda q, k, v: flash_attention(q, k, v, causal=causal),
                  q, k, v)
    pairs = S * (S + 1) // 2 if causal else S * S
    assert got["kernels"] == {"flash_attention": {
        "calls": 1, "flops": 4 * B * H * hd * pairs,
        "bytes": 2 * hd * B * S * (2 * H + 2 * KV)}}
    assert got["flops"] == 4 * B * H * hd * pairs
    assert got["result"].shape == (B, S, H, hd)
    assert got["result"].device == META


# -- the mesh and model_flops -------------------------------------------------
def test_production_mesh_folds_the_pods_into_data():
    assert mesh.production_mesh() == (16, 16)
    assert mesh.production_mesh(multi_pod=True) == (32, 16)
    assert mesh.data_axis_size(mesh.production_mesh(True)) == 32
    assert mesh.logical_rules(True)["data"] == ("pod", "data")
    assert [mesh.mesh_name(mp) for mp in (False, True)] == ["16x16",
                                                            "2x16x16"]
    assert dryrun.link(range(8)) == "nvlink"
    assert dryrun.link(range(16)) == "net"
    assert dryrun.link(range(3, 256, 16)) == "net"


REFERENCE_FLOPS = """
import json
from repro.configs import ARCH_NAMES, get_config
from repro.configs.shapes import SHAPES
from repro.launch.dryrun import model_flops, opt_config_for
print(json.dumps({a: {s: [model_flops(get_config(a), SHAPES[s]),
                          opt_config_for(get_config(a)).factored]
                      for s in SHAPES} for a in ARCH_NAMES}))
"""


def test_model_flops_equal_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE_FLOPS], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(want) == sorted(ARCH_NAMES)
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for s, shape in SHAPES.items():
            flops, factored = want[arch][s]
            assert dryrun.model_flops(cfg, shape) == flops, (arch, s)
            assert dryrun.opt_config_for(cfg).factored == factored


# -- parameter bytes a rank ---------------------------------------------------
def _cut_bytes(cfg, mesh_, rank) -> int:
    """The bytes of ``leaf_place``'s cuts of every whole leaf for the rank
    at data index ``rank // M``, model index ``rank % M``."""
    d, m = mesh_
    whole = build_model(cfg).init(0, device=META)
    total = []

    def part(path, t):
        shape = list(t.shape)
        for dim, axis, n, block in leaf_place(path, cfg, mesh_).cuts:
            lo, hi = axis_range(n, block, rank // m if axis == "data"
                                else rank % m)
            shape[dim] = hi - lo
        total.append(torch.Size(shape).numel() * t.element_size())

    tree_map_paths(part, whole)
    return sum(total)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rank_bytes_are_the_sum_of_the_cuts(arch):
    cfg = get_config(arch)
    for mp in (False, True):
        mesh_ = mesh.production_mesh(mp)
        for rank in (0, mesh_[1] - 1):
            world = init_dry_world(rank, mesh_)
            try:
                got = dryrun._step(cfg, SHAPES["prefill_32k"], world, 1,
                                   trace=False)["param_bytes"]
            finally:
                close_world()
            assert got == _cut_bytes(cfg, mesh_, rank), (arch, mp, rank)


# -- dry against real ---------------------------------------------------------
CELLS = (("granite-20b", "train", 32), ("dbrx-132b", "prefill", 32),
         ("zamba2-7b", "decode", 32), ("seamless-m4t-medium", "train", 32))


@pytest.mark.parametrize("arch,kind,seq", CELLS)
def test_dry_trace_is_the_real_cpu_step(arch, kind, seq):
    cfg = ranks.axis_config(arch)
    dry = dryrun.trace_rank(cfg, ShapeCell(kind, seq, 4, kind), (1, 1),
                            exact=True)
    real = ranks.dry_step_costs(None, arch, kind, 4, seq)
    for key in ("flops", "bytes", "argument_bytes", "kernels",
                "bytes_by_op"):
        assert dry[key] == real[key], key


WORLD_CELLS = (("granite-20b", "train"), ("dbrx-132b", "train"),
               ("mamba2-2.7b", "prefill"), ("zamba2-7b", "decode"))


@pytest.fixture(scope="module")
def world2x2():
    jobs = [(f"{a}/{k}", "dry_step_costs", (a, k, 8, 32))
            for a, k in WORLD_CELLS]
    return run_world(ranks.axis_jobs, 4, jobs, device="cpu", mesh=(2, 2),
                     timeout=300)


@pytest.mark.parametrize("arch,kind", WORLD_CELLS)
def test_dry_collectives_are_the_gloo_ranks(world2x2, arch, kind):
    cfg = ranks.axis_config(arch)
    shape = ShapeCell(kind, 32, 8, kind)
    for rank in (0, 1):
        dry = dryrun.trace_rank(cfg, shape, (2, 2), rank, exact=True)
        real = world2x2[rank][f"{arch}/{kind}"]
        assert dry["collective_detail"] == real["collective_detail"]
        assert dry["collective_detail"]          # something was counted
        assert dry["flops"] == real["flops"]


@pytest.mark.parametrize("arch", ("granite-20b", "zamba2-7b",
                                  "seamless-m4t-medium", "dbrx-132b"))
@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_shallow_traces_extrapolate_to_the_full_depth(arch, kind):
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=6, enc_layers=(
        5 if cfg.enc_layers else 0), shared_every=(
        2 if cfg.shared_every else 0))
    shape = ShapeCell(kind, 64, 8, kind)
    full = dryrun.trace_rank(cfg, shape, (2, 4), 3, exact=True)
    cut = dryrun.trace_rank(cfg, shape, (2, 4), 3)
    assert cut["extrapolated"] and not full["extrapolated"]
    for key in ("flops", "bytes", "collective_detail", "kernels",
                "bytes_by_op", "peak_bytes", "param_bytes",
                "argument_bytes"):
        assert cut[key] == full[key], key


# -- run_cell -----------------------------------------------------------------
FAMILY_CELLS = (("granite-20b", "train_4k"), ("dbrx-132b", "decode_32k"),
                ("mamba2-2.7b", "long_500k"), ("zamba2-7b", "decode_32k"),
                ("paligemma-3b", "train_4k"),
                ("seamless-m4t-medium", "decode_32k"))


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_run_cell_smoke(tmp_path, arch, shape):
    rec = dryrun.run_cell(arch, shape, False, str(tmp_path), mesh=(4, 4),
                          smoke=True)
    assert rec["status"] == "ok", rec
    for key in ("lower_s", "compile_s", "devices", "flops_total",
                "bytes_total", "model_flops", "collectives",
                "unknown_while", "collective_top", "xla_cost_raw", "memory",
                "params", "terms", "dominant"):
        assert key in rec, key
    assert rec["devices"] == 16 and rec["flops_total"] > 0
    assert [r["model_rank"] for r in rec["ranks"]] == [0, 3]
    assert rec["dominant"] in rec["terms"]
    assert 0 < rec["memory"]["argument_bytes"] <= rec["memory"][
        "peak_bytes"]
    written = json.loads((tmp_path / f"{arch}__{shape}__4x4.json")
                         .read_text())
    assert written["terms"] == rec["terms"]


def test_long_500k_is_skipped_for_quadratic_configs():
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        quadratic = cfg.family not in ("ssm", "hybrid") and \
            cfg.attn == "full"
        assert applicable(cfg, SHAPES["long_500k"])[0] != quadratic
        if quadratic:
            rec = dryrun.run_cell(arch, "long_500k", False, "")
            assert rec["status"] == "skip", arch
            assert rec["reason"] == "full attention is quadratic at 500k"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-20b", "--shape", "long_500k", "--out", ""], env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SKIP (full attention is quadratic at 500k)" in out.stdout
