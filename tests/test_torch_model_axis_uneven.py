"""The model axis where ``M`` does not divide the query heads, the K/V
heads, ``d_ff`` or the padded vocab (gloo, the CPU, SMOKE sizes in fp32
with each FULL config's ``fsdp`` and ``remat``): blocks of ``ceil(n /
M)``, the last short or empty; K/V heads that ``M`` does not divide
replicated, each rank reading the ones its query heads read (expanded to
one a query head where its block straddles groups unevenly).

* (i) a world of 1 x 4 ranks, heads 2/2/2/0: deepseek-coder-33b with 6
  heads on 2 K/V heads (rank 1's heads read K/V heads 0 and 1),
  paligemma-3b with 6 heads (the prefix mask), llama4-maverick with 6
  heads (chunked attention beside the expert axis) and zamba2-7b with 6
  heads on 6 K/V heads and ``d_ff`` 126 (the hybrid's shared block; d_ff
  blocks 32/32/32/30);
* (ii) a world of 1 x 3 ranks: granite-20b (4 heads 2/2/0: a rank with no
  heads; its vocab of 512 cut 171/171/170), seamless-m4t-medium
  (cross-attention, the vocab cut the same way) and deepseek-coder-33b
  with 8 heads on 2 K/V heads (3/3/2: rank 1's heads 3-5 read K/V heads
  0, 1, 1 and are expanded);

  each config's forward (gathered over ``model``) within ``rtol = atol =
  1e-5`` of the port's one device and of the JAX package's forward from
  the same weights, the ``pallas`` prefill and 4 teacher-forced decode
  steps within ``1e-5`` of one device, the KV cache holding each rank's
  K/V heads (``Par.kv_range``), each rank's ``init`` its slices of the
  one-device init bit for bit, the MoE routes one device's;
* (iii) training: deepseek-coder-33b (6 heads) over the 1 x 4 world and
  granite-20b over a world of 2 x 3 (FSDP over ``data`` beside a model
  rank with no heads), the plain and the factored optimizer, three steps
  each against the one-device ``microbatch=D`` steps within the train gate
  (``rtol = 1e-5``, every parameter and state leaf within ``1e-5``);
  granite's 2 x 3 save restored on one device is the world's tree bit for
  bit, and one more step from it is that step from the world's tree bit
  for bit and within the gate of the uninterrupted one-device run;
* (iv) placement alone, no world, every FULL config at ``M`` in {2, 3, 4,
  8, 16} and ``D`` in {1, 2, 16}: ``check_model_axis`` takes every ``M``
  from 2 to 16; the model blocks of every leaf tile its dim exactly once
  (the SSM's ``d_inner`` in blocks of whole heads); ``kv_range``
  covers exactly the K/V heads each rank's heads read, and ``kv_index``
  maps each local head to its own; at SMOKE size, the bytes a rank keeps
  (``take_cuts`` of the whole tree) are the sum of ``leaf_place``'s cuts.

Each world runs all of its configs in one spawn (module fixtures); the JAX
forwards run in this process meanwhile.
"""
import concurrent.futures
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model

from repro_torch.ckpt import restore_checkpoint
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed import run_world
from repro_torch.interop import lm_params_to_reference
from repro_torch.launch.train import opt_config_for
from repro_torch.models import build_model
from repro_torch.models.attention import kv_index
from repro_torch.models.common import (Par, axis_range, check_model_axis,
                                       leaf_place, take_cuts, tree_leaves,
                                       tree_map_paths)
from repro_torch.optim import adamw_init

IN4 = ("deepseek-coder-33b+h6", "paligemma-3b+h6",
       "llama4-maverick-400b-a17b+h6", "zamba2-7b+h6kv6")
IN3 = ("granite-20b", "seamless-m4t-medium", "deepseek-coder-33b+h8")
B, DECODE = 2, 4
SEQ = {4: 64, 3: 48}                 # sequence parallelism: S divides M
STEPS = 3
FACTORED = dict(factored=True, master_fp32=False, warmup=2)
TOL = RTOL = 1e-5


def reference_forward(arch, seq) -> np.ndarray:
    """The JAX package's forward of the port's ``init(0)`` weights."""
    cfg = ranks.axis_config(arch)
    name, plus, variant = arch.partition("+")
    params = build_model(cfg).init(0, device="cpu")
    jm = jax_build_model(jax_get_config(
        name, smoke=True, fsdp=cfg.fsdp, remat=cfg.remat,
        **(ranks.VARIANTS[plus + variant] if plus else {})))
    jp = jax.tree.map(jnp.asarray, lm_params_to_reference(params))
    batch = ranks.axis_batch(cfg, 7, B, seq)
    logits, _ = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return np.asarray(logits)


def _world(size, mesh, jobs, refs):
    """``jobs`` in one world of ``size`` ranks over ``mesh``; the JAX
    forwards of ``refs`` (arch -> positions) meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_world, ranks.axis_jobs, size, jobs,
                        device="cpu", mesh=mesh, timeout=300)
        got = {a: reference_forward(a, s) for a, s in refs.items()}
        return fut.result(), got


@pytest.fixture(scope="module")
def in4():
    S = SEQ[4]
    jobs = [(f"serve/{a}", "axis_serve", (a, B, S, DECODE)) for a in IN4]
    jobs += [(f"train/{opt}", "axis_train",
              (IN4[0], STEPS, 4, S, FACTORED if opt else None))
             for opt in (None, "factored")]
    results, refs = _world(4, (1, 4), jobs, {a: S for a in IN4})
    return dict(results=results, refs=refs)


@pytest.fixture(scope="module")
def in3():
    S = SEQ[3]
    jobs = [(f"serve/{a}", "axis_serve", (a, B, S, DECODE)) for a in IN3]
    results, refs = _world(3, (1, 3), jobs, {a: S for a in IN3})
    return dict(results=results, refs=refs)


@pytest.fixture(scope="module")
def in2x3(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("uneven_2x3") / "granite")
    jobs = [("train/None", "axis_train", ("granite-20b", STEPS, 4, SEQ[3],
                                          None, ckpt)),
            ("train/factored", "axis_train", ("granite-20b", STEPS, 4,
                                              SEQ[3], FACTORED))]
    results = run_world(ranks.axis_jobs, 6, jobs, device="cpu",
                        mesh=(2, 3), timeout=300)
    return dict(results=results, ckpt=ckpt)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _par(cfg, d, m, di=0, mi=0):
    """``cfg``'s :class:`Par` on the rank at data index ``di``, model index
    ``mi`` of a ``d x m`` mesh (a stand-in world: its axes' ranks and
    sizes)."""
    world = types.SimpleNamespace(
        mesh=(d, m), data=types.SimpleNamespace(rank=di, size=d),
        model=types.SimpleNamespace(rank=mi, size=m))
    return Par(world, fsdp=cfg.fsdp and d > 1, sp=cfg.fsdp and m > 1)


# -- (i), (ii): serving ------------------------------------------------------
SERVE = [(4, a) for a in IN4] + [(3, a) for a in IN3]


@pytest.fixture(scope="module")
def worlds(in4, in3):
    return {4: in4, 3: in3}


@pytest.fixture(scope="module")
def single():
    """The port's one-device forward, prefill and decode of each case."""
    return {arch: ranks.axis_serve(None, arch, B, SEQ[m], DECODE)
            for m, arch in SERVE}


@pytest.mark.parametrize("m,arch", SERVE)
def test_forward_equals_one_device_and_reference(worlds, single, m, arch):
    w = worlds[m]
    one = single[arch]
    rows = [r[f"serve/{arch}"] for r in w["results"]]
    assert len(rows) == m and all(row["shard_is_init"] for row in rows)
    for row in rows:
        close(row["logits"], one["logits"])
        assert len(row["routes"]) == len(one["routes"])
        for x, y in zip(row["routes"], one["routes"]):
            assert torch.equal(x, y)
    close(rows[0]["logits"], w["refs"][arch])
    close(one["logits"], w["refs"][arch])


@pytest.mark.parametrize("m,arch", SERVE)
def test_prefill_and_decode_equal_one_device(worlds, single, m, arch):
    cfg = ranks.axis_config(arch)
    one = single[arch]
    for i, r in enumerate(worlds[m]["results"]):
        row = r[f"serve/{arch}"]
        close(row["prefill"], one["prefill"])
        assert row["decode"].shape[1] == DECODE
        close(row["decode"], one["decode"])
        lo, hi = _par(cfg, 1, m, mi=i).kv_range(cfg)
        assert row["kv_heads"] == hi - lo


def test_the_cases_are_the_ones_named():
    """Rank 1 of deepseek's 1 x 4 world straddles K/V heads 0 and 1; a
    rank of the 1 x 3 worlds has no heads (granite's, seamless's) or
    straddles groups unevenly (deepseek with 8 heads, expanded); the
    vocab of 512 goes 171/171/170 over 3 and zamba2's d_ff 126
    32/32/32/30 over 4."""
    ds6 = ranks.axis_config(IN4[0])
    assert [_par(ds6, 1, 4, mi=i).head_range(ds6) for i in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 6)]
    assert _par(ds6, 1, 4, mi=1).kv_range(ds6) == (0, 2)
    ds8 = ranks.axis_config(IN3[2])
    assert kv_index(ds8, _par(ds8, 1, 3, mi=1)) == (0, 1, 1)
    gr = ranks.axis_config("granite-20b")
    assert _par(gr, 1, 3, mi=2).head_range(gr) == (4, 4)
    blocks = [leaf_place(("embed", "tok"), gr, (1, 3)).cuts[0]]
    assert [axis_range(512, blocks[0][3], i) for i in range(3)] == [
        (0, 171), (171, 342), (342, 512)]
    zb = ranks.axis_config(IN4[3])
    cut = leaf_place(("shared", "ffn", "w_in"), zb, (1, 4)).cuts[0]
    spans = [axis_range(126, cut[3], i) for i in range(4)]
    assert [hi - lo for lo, hi in spans] == [32, 32, 32, 30]


# -- (iii): training ----------------------------------------------------------
def _held(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    for x, y in zip(tree_leaves(got["params"]) + tree_leaves(got["state"]),
                    tree_leaves(want["params"]) + tree_leaves(want["state"])):
        assert x.shape == y.shape and x.dtype == y.dtype
        close(x.float(), y.float())


@pytest.mark.parametrize("opt", (None, "factored"))
def test_1x4_steps_equal_one_device(in4, opt):
    rows = [r[f"train/{opt}"] for r in in4["results"]]
    assert all(r["losses"] == rows[0]["losses"] for r in rows)
    _held(rows[0], ranks.axis_train(None, IN4[0], STEPS, 4, SEQ[4],
                                    FACTORED if opt else None))


@pytest.mark.parametrize("opt", (None, "factored"))
def test_2x3_steps_equal_one_device(in2x3, opt):
    rows = [r[f"train/{opt}"] for r in in2x3["results"]]
    assert all(r["losses"] == rows[0]["losses"] for r in rows)
    _held(rows[0], ranks.axis_train(None, "granite-20b", STEPS, 4, SEQ[3],
                                    FACTORED if opt else None, microbatch=2))


def test_2x3_checkpoint_restores_on_one_device(in2x3):
    from repro_torch.train import build_train_step
    arch = "granite-20b"
    cfg = ranks.axis_config(arch)
    opt = opt_config_for(cfg, STEPS)
    model = build_model(cfg)
    world = in2x3["results"][0]["train/None"]
    fresh = model.init(1, device="cpu")
    tree, step = restore_checkpoint(
        in2x3["ckpt"], {"params": fresh, "opt": adamw_init(fresh, opt)},
        device="cpu")
    assert step == STEPS
    mine = tree_leaves(world["params"]) + tree_leaves(world["state"])
    got = tree_leaves(tree["params"]) + tree_leaves(tree["opt"])
    assert len(got) == len(mine)
    for x, y in zip(got, mine):
        assert torch.equal(x, y)
    batch = {k: v for k, v in ranks.as_torch(ranks.axis_batch(
        cfg, STEPS, 4, SEQ[3])).items()}
    train = build_train_step(model, opt, microbatch=2)
    _, _, resumed = train(tree["params"], tree["opt"], batch)
    _, _, again = train(world["params"], world["state"], batch)
    assert float(resumed["loss"]) == float(again["loss"])
    straight = ranks.axis_train(None, arch, STEPS + 1, 4, SEQ[3],
                                microbatch=2)
    np.testing.assert_allclose(float(resumed["loss"]),
                               straight["losses"][-1], rtol=RTOL)


# -- (iv): placement ------------------------------------------------------------
MESH_M = (2, 3, 4, 8, 16)
MESH_D = (1, 2, 16)


def _paths(arch):
    """The leaf paths of ``arch``'s params tree (its SMOKE config's: the
    FULL tree has the same leaves)."""
    out = []
    tree_map_paths(lambda p, _: out.append(p),
                   build_model(get_config(arch, smoke=True)).init(
                       0, device="cpu"))
    return out


@pytest.fixture(scope="module")
def paths():
    return {a: _paths(a) for a in ARCH_NAMES}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_check_model_axis_refuses_only_experts_and_ssm_heads(arch):
    """No model axis is refused any more: every FULL config takes every
    ``M`` from 2 to 16, experts and SSM heads in ceil blocks."""
    cfg = get_config(arch)
    for m in range(2, 17):
        check_model_axis(cfg, m)
    # the three FULL configs whose heads M = 16 does not divide
    if arch in ("deepseek-coder-33b", "paligemma-3b",
                "llama4-maverick-400b-a17b"):
        assert cfg.n_heads % 16


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_blocks_tile_every_leaf(arch, paths):
    cfg = get_config(arch)
    for m in MESH_M:
        for d in MESH_D:
            for path in paths[arch]:
                place = leaf_place(path, cfg, (d, m))
                for dim, axis, whole, block in place.cuts:
                    n = m if axis == "model" else d
                    d_inner = "mix" in path and path[-1] in (
                        "wz", "wx", "conv_x", "norm", "out")
                    assert block == (
                        -(-cfg.ssm_heads // n) * cfg.ssm_headdim if d_inner
                        and axis == "model" else -(-whole // n)) or (
                        path[-1] in ("tok", "unembed") and axis == "model")
                    spans = [axis_range(whole, block, i) for i in range(n)]
                    assert spans[0][0] == 0 and spans[-1][1] == whole
                    for (lo, hi), (lo2, _) in zip(spans, spans[1:]):
                        assert lo <= hi == lo2, (path, spans)
                    if axis == "data":
                        assert whole % d == 0
                if path[-1] in ("wk", "wv") and m > 1:
                    assert (place.model is None) == bool(
                        cfg.n_kv_heads % m)
                    assert place.sum_model == bool(cfg.n_kv_heads % m)


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES
                                  if get_config(a).family != "ssm"])
def test_kv_range_covers_the_heads_read(arch):
    cfg = get_config(arch)
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    for m in MESH_M:
        seen = []
        for i in range(m):
            par = _par(cfg, 1, m, mi=i)
            lo, hi = par.head_range(cfg)
            seen += range(lo, hi)
            klo, khi = par.kv_range(cfg)
            assert set(range(klo, khi)) == {h // G for h in range(lo, hi)}
            idx = kv_index(cfg, par)
            want = tuple(h // G - klo for h in range(lo, hi))
            if idx is not None:
                assert idx == want
            elif hi > lo:                   # equal contiguous groups
                g = (hi - lo) // (khi - klo)
                assert want == tuple(j // g for j in range(hi - lo))
        assert seen == list(range(H))
    if arch == "deepseek-coder-33b":   # G = 7 in blocks of 4 and of 19
        assert kv_index(cfg, _par(cfg, 1, 16, mi=1)) == (0, 0, 0, 1)
        assert _par(cfg, 1, 16, mi=15).head_range(cfg) == (56, 56)
        assert kv_index(cfg, _par(cfg, 1, 3, mi=0)) is not None


def test_factored_slabs_pair_up_over_short_blocks():
    """Where the model axis cuts one of a leaf's last two dims, the
    factored moments reduce over ``model`` slab by slab, so every model
    rank must take the same slabs: deepseek-coder-33b FULL's ``wq`` (62,
    7168, H_local, 128) and ``w_in`` (62, 7168, F_local) at M = 3 (heads
    19/19/18) and 16 (4 a rank, two ranks with none)."""
    from repro_torch.optim.adamw import _matrices, _slab_shape
    cfg = get_config("deepseek-coder-33b")
    for m in (3, 16):
        for name in ("attn", "wq"), ("ffn", "w_in"):
            place = leaf_place(("layers",) + name, cfg, (1, m))
            dim, _, whole, block = place.cuts[0]
            shape = [62, 7168, cfg.n_heads, cfg.hd][:4 if name[1] == "wq"
                                                     else 3]
            if name[1] == "w_in":
                shape[2] = cfg.d_ff
            slabs = set()
            for i in range(m):
                lo, hi = axis_range(whole, block, i)
                shape[dim] = hi - lo
                slabs.add(tuple(map(str, _matrices(_slab_shape(
                    tuple(shape), place)))))
            assert len(slabs) == 1, (m, name)


def _part_bytes(path, cfg, mesh, di, mi, whole) -> int:
    """The bytes of the rank at (``di``, ``mi``) of ``leaf_place``'s cuts
    of a leaf ``whole``."""
    shape = list(whole.shape)
    for dim, axis, n, block in leaf_place(path, cfg, mesh).cuts:
        lo, hi = axis_range(n, block, di if axis == "data" else mi)
        shape[dim] = hi - lo
    return math.prod(shape) * whole.element_size()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rank_bytes_are_the_sum_of_the_cuts(arch):
    cfg = get_config(arch, smoke=True)
    whole = build_model(cfg).init(0, device="cpu")
    leaves = []
    tree_map_paths(lambda p, t: leaves.append((p, t)), whole)
    for m in MESH_M:
        for d in MESH_D:
            cfg_m = dataclasses.replace(cfg, fsdp=True) if d > 1 else cfg
            for mi in range(m):
                for di in {0, d - 1}:
                    world = _par(cfg_m, d, m, di, mi).world
                    kept = sum(
                        take_cuts(t, leaf_place(p, cfg_m, (d, m)).cuts,
                                  world).nbytes for p, t in leaves)
                    want = sum(_part_bytes(p, cfg_m, (d, m), di, mi, t)
                               for p, t in leaves)
                    assert kept == want
