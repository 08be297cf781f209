"""The model axis where ``M`` does not divide the experts or the SSM heads
(gloo, the CPU, SMOKE sizes in fp32 with each FULL config's ``fsdp`` and
``remat``): experts and SSM heads in blocks of ``ceil(n / M)``, the last
short or empty, the SSM's ``d_inner`` in blocks of whole heads.

* (i) a world of 1 x 3 ranks: dbrx-132b (4 experts 2/2/0: a rank with no
  experts, and 4 heads 2/2/0), llama4-maverick (4 experts 2/2/0 beside
  the shared expert, chunked attention), mamba2-2.7b (8 SSM heads 3/3/2),
  mamba2-2.7b with two SSM heads of 64 channels (1/1/0: a rank with no
  SSM heads) and zamba2-7b (8 SSM heads 3/3/2, its shared block's 4 heads
  2/2/0): each forward (gathered over ``model``) within ``rtol = atol =
  1e-5`` of the port's one device and of the JAX package's forward from
  the same weights, the ``pallas`` prefill and 8 teacher-forced decode
  steps within ``1e-5`` of one device, the MoE routes one device's, the
  SSM caches holding each rank's heads, each rank's ``init`` its slices
  of the one-device init bit for bit;
* the gated norm's divisor: mamba2's mixer over 8 SSM heads cut 3/3/2 by
  hand, the ranks' outputs summed, is the whole mixer's within ``1e-5``
  (a divisor of the local width times ``M`` misses it by ~10 %);
* (ii) training: dbrx-132b and mamba2-2.7b two steps over the 1 x 3 world,
  saved there and restored on one device bit for bit; three steps over a
  world of 2 x 3 (FSDP over ``data`` beside a model rank with no
  experts), the plain and, for dbrx, the factored optimizer, within the
  train gate of the one-device ``microbatch=2`` steps;
* (iii) placement alone, no world: every FULL config takes every ``M``
  from 2 to 16; for ``M`` in {3, 5, 6, 7, 12, 16} the model blocks tile
  every leaf, ``d_inner`` in whole heads, and the factored moments'
  slabs of the experts pair up over ``data``.

Each world runs all of its cases in one spawn (module fixtures); the JAX
forwards run in this process meanwhile.
"""
import concurrent.futures

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
from repro_torch.models.common import (axis_range, check_model_axis,
                                       leaf_place, model_block, tree_leaves,
                                       tree_map_paths)
from repro_torch.optim import adamw_init

SERVE = ("dbrx-132b", "llama4-maverick-400b-a17b", "mamba2-2.7b",
         "mamba2-2.7b+ssm2", "zamba2-7b")
TRAIN = ("dbrx-132b", "mamba2-2.7b")
B, S, DECODE, STEPS = 2, 48, 8, 3
FACTORED = dict(factored=True, master_fp32=False, warmup=2)
TOL = RTOL = 1e-5


def reference_forward(arch) -> np.ndarray:
    """The JAX package's forward of the port's ``init(0)`` weights."""
    cfg = ranks.axis_config(arch)
    name, plus, variant = arch.partition("+")
    params = build_model(cfg).init(0, device="cpu")
    jm = jax_build_model(jax_get_config(
        name, smoke=True, fsdp=cfg.fsdp, remat=cfg.remat,
        **(ranks.VARIANTS[plus + variant] if plus else {})))
    jp = jax.tree.map(jnp.asarray, lm_params_to_reference(params))
    batch = ranks.axis_batch(cfg, 7, B, S)
    logits, _ = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return np.asarray(logits)


@pytest.fixture(scope="module")
def in3(tmp_path_factory):
    root = tmp_path_factory.mktemp("experts_heads_1x3")
    jobs = [(f"serve/{a}", "axis_serve", (a, B, S, DECODE)) for a in SERVE]
    jobs += [(f"train/{a}", "axis_train", (a, 2, 4, S, None,
                                           str(root / a)))
             for a in TRAIN]
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_world, ranks.axis_jobs, 3, jobs, device="cpu",
                        mesh=(1, 3), timeout=300)
        refs = {a: reference_forward(a) for a in SERVE}
        results = fut.result()
    return dict(results=results, refs=refs, root=root)


@pytest.fixture(scope="module")
def mixer3():
    """mamba2's first mixer over a 1 x 3 world on hand-cut heads: a world
    of its own, which needs nothing of the model axis but the gated norm's
    all-reduce."""
    return run_world(ranks.axis_jobs, 3,
                     [("mamba", "axis_mamba", ("mamba2-2.7b", B, S))],
                     device="cpu", mesh=(1, 3), timeout=300)


@pytest.fixture(scope="module")
def in2x3():
    jobs = [(f"train/{a}/None", "axis_train", (a, STEPS, 4, S, None))
            for a in TRAIN]
    jobs.append(("train/dbrx-132b/factored", "axis_train",
                 ("dbrx-132b", STEPS, 4, S, FACTORED)))
    return run_world(ranks.axis_jobs, 6, jobs, device="cpu", mesh=(2, 3),
                     timeout=300)


@pytest.fixture(scope="module")
def single():
    return {a: ranks.axis_serve(None, a, B, S, DECODE) for a in SERVE}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _blocks(n, m):
    return [hi - lo for lo, hi in (axis_range(n, model_block(n, m), i)
                                   for i in range(m))]


# -- (i): serving -------------------------------------------------------------
def test_the_cases_are_the_ones_named():
    """A rank with no experts (dbrx's and llama4's 4 over 3), SSM heads
    3/3/2 (mamba2's and zamba2's 8), a rank with no SSM heads (mamba2's 2
    over 3) and zamba2's shared block 2/2/0."""
    for arch in SERVE[:2]:
        assert _blocks(ranks.axis_config(arch).n_experts, 3) == [2, 2, 0]
    for arch in ("mamba2-2.7b", "zamba2-7b"):
        assert _blocks(ranks.axis_config(arch).ssm_heads, 3) == [3, 3, 2]
    assert _blocks(ranks.axis_config("mamba2-2.7b+ssm2").ssm_heads, 3) == [
        1, 1, 0]
    assert _blocks(ranks.axis_config("zamba2-7b").n_heads, 3) == [2, 2, 0]


@pytest.mark.parametrize("arch", SERVE)
def test_forward_equals_one_device_and_reference(in3, single, arch):
    one = single[arch]
    rows = [r[f"serve/{arch}"] for r in in3["results"]]
    assert len(rows) == 3 and all(row["shard_is_init"] for row in rows)
    for row in rows:
        close(row["logits"], one["logits"])
        assert len(row["routes"]) == len(one["routes"])
        for x, y in zip(row["routes"], one["routes"]):
            assert torch.equal(x, y)
    close(rows[0]["logits"], in3["refs"][arch])
    close(one["logits"], in3["refs"][arch])


@pytest.mark.parametrize("arch", SERVE)
def test_prefill_and_decode_equal_one_device(in3, single, arch):
    cfg = ranks.axis_config(arch)
    heads = _blocks(cfg.ssm_heads, 3)
    for i, r in enumerate(in3["results"]):
        row = r[f"serve/{arch}"]
        close(row["prefill"], single[arch]["prefill"])
        assert row["decode"].shape[1] == DECODE
        close(row["decode"], single[arch]["decode"])
        if cfg.family in ("ssm", "hybrid"):
            L, K, hd = cfg.n_layers, cfg.ssm_conv, cfg.ssm_headdim
            assert row["ssm"] == (
                (L, B, heads[i], hd, cfg.ssm_state),
                (L, B, K - 1, heads[i] * hd + 2 * cfg.ssm_state))


def test_gated_norm_divides_by_the_whole_d_inner(mixer3):
    """Fault 1: each rank's mixer over its 3, 3 or 2 heads normalises by
    the sum of squares over all 128 channels divided by 128, so that the
    ranks' outputs sum to the whole mixer's and the states join into its
    state."""
    from repro_torch.models import ssm
    from repro_torch.models.common import tree_map
    cfg = ranks.axis_config("mamba2-2.7b")
    whole = tree_map(lambda t: t[0], build_model(cfg).init(
        0, device="cpu")["layers"]["mix"])
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    y, h = ssm.mamba_forward(whole, x, cfg)
    rows = [r["mamba"] for r in mixer3]
    assert [r["h"].shape[1] for r in rows] == [3, 3, 2]
    close(sum(r["y"] for r in rows), y)
    close(torch.cat([r["h"] for r in rows], 1), h)


# -- (ii): training -----------------------------------------------------------
@pytest.mark.parametrize("arch", TRAIN)
def test_1x3_save_restores_on_one_device(in3, arch):
    cfg = ranks.axis_config(arch)
    opt = opt_config_for(cfg, 2)
    world = in3["results"][0][f"train/{arch}"]
    assert all(r[f"train/{arch}"]["losses"] == world["losses"]
               for r in in3["results"])
    fresh = build_model(cfg).init(1, device="cpu")
    tree, step = restore_checkpoint(
        str(in3["root"] / arch),
        {"params": fresh, "opt": adamw_init(fresh, opt)}, device="cpu")
    assert step == 2
    got = tree_leaves(tree["params"]) + tree_leaves(tree["opt"])
    mine = tree_leaves(world["params"]) + tree_leaves(world["state"])
    assert len(got) == len(mine)
    for x, y in zip(got, mine):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("arch,opt", [(a, None) for a in TRAIN]
                         + [("dbrx-132b", "factored")])
def test_2x3_steps_equal_one_device(in2x3, arch, opt):
    rows = [r[f"train/{arch}/{opt}"] for r in in2x3]
    assert all(r["losses"] == rows[0]["losses"] for r in rows)
    want = ranks.axis_train(None, arch, STEPS, 4, S,
                            FACTORED if opt else None, microbatch=2)
    np.testing.assert_allclose(rows[0]["losses"], want["losses"], rtol=RTOL)
    for x, y in zip(tree_leaves(rows[0]["params"])
                    + tree_leaves(rows[0]["state"]),
                    tree_leaves(want["params"]) + tree_leaves(want["state"])):
        assert x.shape == y.shape and x.dtype == y.dtype
        close(x.float(), y.float())


# -- (iii): placement ---------------------------------------------------------
M_ODD = (3, 5, 6, 7, 12, 16)


def _paths(arch):
    out = []
    tree_map_paths(lambda p, _: out.append(p),
                   build_model(get_config(arch, smoke=True)).init(
                       0, device="cpu"))
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_model_axis_is_taken(arch):
    cfg = get_config(arch)
    for m in range(1, 17):
        check_model_axis(cfg, m)
        build_model(cfg, world=None)
    with pytest.raises(ValueError):
        check_model_axis(cfg, 0)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_blocks_tile_with_whole_ssm_heads(arch):
    cfg = get_config(arch)
    hd = cfg.ssm_headdim
    for m in M_ODD:
        for path in _paths(arch):
            place = leaf_place(path, cfg, (1, m))
            if place.model is None:
                continue
            _, _, whole, block = next(c for c in place.cuts
                                      if c[1] == "model")
            spans = [axis_range(whole, block, i) for i in range(m)]
            assert spans[0][0] == 0 and spans[-1][1] == whole, (path, m)
            for (lo, hi), (lo2, _) in zip(spans, spans[1:]):
                assert lo <= hi == lo2, (path, spans)
            if "mix" in path and path[-1] in ("wz", "wx", "conv_x", "norm",
                                               "out"):
                # d_inner in whole heads: rank i's channels are the
                # channels of its SSM heads
                heads = [axis_range(cfg.ssm_heads, model_block(
                    cfg.ssm_heads, m), i) for i in range(m)]
                assert spans == [(lo * hd, hi * hd) for lo, hi in heads]
            elif path[-1] in ("w_in", "w_gate", "w_out") and \
                    cfg.family == "moe" and path[0] != "shared":
                assert block == model_block(cfg.n_experts, m)
    if arch == "mamba2-2.7b":   # 80 heads over 3: 27/27/26, 1728 channels
        assert leaf_place(("layers", "mix", "wx"), cfg, (1, 3)).cuts[0][
            3] == 27 * 64
    if arch == "dbrx-132b":     # 16 experts over 12: 2 a rank, 4 ranks none
        assert _blocks(cfg.n_experts, 12) == [2] * 8 + [0] * 4


def test_factored_expert_slabs_pair_up_over_data():
    """The factored moments of an expert weight reduce over ``data``
    (FSDP cuts its ``d_model``) slab by slab: the data ranks of one model
    rank hold the same experts, so they take the same slabs, an empty
    block included (dbrx FULL, ``M = 12``)."""
    from repro_torch.optim.adamw import _matrices, _slab_shape
    cfg = get_config("dbrx-132b")
    path = ("layers", "ffn", "w_in")
    for d in (2, 16):
        place = leaf_place(path, cfg, (d, 12))
        assert place.model == 1 and place.data == 2
        for mi in range(12):
            lo, hi = axis_range(16, 2, mi)
            shape = (cfg.n_layers, hi - lo, cfg.d_model // d, cfg.d_ff)
            slabs = {tuple(map(str, _matrices(_slab_shape(shape, place))))
                     for _ in range(d)}
            assert len(slabs) == 1


def test_a_rank_with_no_experts_joins_the_backward():
    """One device's view of a rank with no experts (the last of 4 over a
    model axis of 3): ``moe_ffn``'s output is zero and a tensor of the
    autograd graph, so that the block's reduction of the input gradient
    reaches it."""
    import types

    from repro_torch.models.moe import moe_ffn
    cfg = ranks.axis_config("dbrx-132b")
    p = build_model(cfg).init(0, device="cpu")["layers"]["ffn"]
    mine = {k: (t[0, 4:4] if k in ("w_in", "w_gate", "w_out") else t[0])
            for k, t in p.items()}
    axis = types.SimpleNamespace(rank=2, size=3, name="model")
    x = torch.randn(B, S, cfg.d_model, requires_grad=True)
    out, aux = moe_ffn(mine, x, cfg, axis)
    assert out.shape == x.shape and not out.detach().any()
    assert out.requires_grad
    out.sum().backward()
    assert x.grad is not None and not aux["lb_loss"].requires_grad
