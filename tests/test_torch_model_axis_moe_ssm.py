"""The model axis over a world of 1 x 2 ranks (gloo, the CPU) for the MoE,
SSM and hybrid families: dbrx-132b and llama4-maverick (the expert axis,
under sequence parallelism and FSDP as their FULL configs have them;
dbrx also under ``opt_moe_dispatch``), mamba2-2.7b (``d_inner`` and the
SSM heads cut over ``model``) and zamba2-7b (its mamba blocks so, its
shared attention block as an attention block), at SMOKE size in fp32
with their FULL configs' ``fsdp`` and ``remat``.

* the placement (``models.common.leaf_place``) against the JAX package's
  specs, leaf for leaf over a 2 x 2 mesh, with ``opt_moe_dispatch`` on
  and off: the dim ``model`` cuts and the dim ``data`` cuts; the leaves
  whole on every model rank whose gradient is a rank's part
  (``sum_model``: the router, the B/C projections and convolutions);
  ``check_model_axis`` accepting every config of the four families at
  every ``M`` from 2 to 16 (llama4-maverick's 40 heads at 16 in blocks
  of 3; experts and SSM heads in ceil blocks);
* each rank's ``init`` its slices of the one-device init bit for bit; the
  forward's logits (gathered over ``model``) within ``rtol = atol =
  1e-5`` of the port's one device and of the JAX package's forward from
  the same weights (``lm_params_to_reference``);
* every MoE layer's ``assign`` equal on both model ranks and to one
  device's;
* the ``attn_impl="pallas"`` prefill and 8 teacher-forced decode steps
  (the SSM state and convolution caches holding the rank's heads and
  channels, the hybrid's shared K/V cache its K/V heads) within ``1e-5``
  of one device;
* a one-device checkpoint restored into the 1 x 2 world (``1 -> 1x2``) and
  gathered back, leaf for leaf bit for bit.

One world runs every case (a module fixture); the JAX forwards run in this
process meanwhile.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model

from repro_torch.configs import get_config
from repro_torch.distributed import run_world
from repro_torch.interop import lm_params_to_reference
from repro_torch.models import build_model
from repro_torch.models.common import (check_model_axis, leaf_place,
                                       tree_leaves, tree_map_paths)

FAMILIES = ranks.MOE_SSM_ARCHS
ARCHS = FAMILIES + ("dbrx-132b+dispatch",)
B, S, DECODE = 2, 64, 8
TOL = 1e-5


def reference_forward(arch) -> np.ndarray:
    """The JAX package's forward of the port's ``init(0)`` weights."""
    cfg = ranks.axis_config(arch)
    params = build_model(cfg).init(0, device="cpu")
    jm = jax_build_model(jax_get_config(
        arch.split("+")[0], smoke=True, fsdp=cfg.fsdp, remat=cfg.remat,
        opt_moe_dispatch=cfg.opt_moe_dispatch))
    jp = jax.tree.map(jnp.asarray, lm_params_to_reference(params))
    batch = ranks.axis_batch(cfg, 7, B, S)
    logits, _ = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return np.asarray(logits)


@pytest.fixture(scope="module")
def axis(tmp_path_factory):
    root = tmp_path_factory.mktemp("model_axis_moe_ssm")
    ones = {a: ranks.axis_train(None, a, 2, 4, S, ckpt=str(root / a))
            for a in FAMILIES}
    jobs = [(f"serve/{a}", "axis_serve", (a, B, S, DECODE)) for a in ARCHS]
    jobs += [(f"restored/{a}", "axis_restore", (a, str(root / a), 2))
             for a in FAMILIES]
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_world, ranks.axis_suite, 2, jobs, device="cpu",
                        mesh=(1, 2), timeout=300)
        refs = {a: reference_forward(a) for a in ARCHS}
        results = fut.result()
    return dict(results=results, refs=refs, ones=ones)


@pytest.fixture(scope="module")
def single():
    return {a: ranks.axis_serve(None, a, B, S, DECODE) for a in ARCHS}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _reference_specs(arch, dispatch: bool) -> dict:
    jm = jax_build_model(jax_get_config(arch, smoke=True, fsdp=True,
                                        opt_moe_dispatch=dispatch))
    _, specs = jm.init(jax.random.PRNGKey(0))
    flat = {}
    tree_map_paths(lambda path, s: flat.setdefault(path, s), jax.tree.map(
        lambda s: tuple(s), specs,
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
    return flat


@pytest.mark.parametrize("dispatch", (False, True))
@pytest.mark.parametrize("arch", FAMILIES)
def test_placement_follows_reference_specs(arch, dispatch):
    cfg = ranks.axis_config(arch, opt_moe_dispatch=dispatch)
    mesh = (2, 2)
    fsdp = dataclasses.replace(cfg, fsdp=True)
    flat = _reference_specs(arch, dispatch)
    assert any(len(p) > 1 and p[1] in ("ffn", "mix") for p in flat)
    for path, spec in flat.items():
        place = leaf_place(path, fsdp, mesh)
        want_model = spec.index("model") if "model" in spec else None
        assert place.model == want_model, (path, spec, place)
        assert place.data == (spec.index("data") if "data" in spec
                              else None), (path, spec, place)
        assert leaf_place(path, dataclasses.replace(cfg, fsdp=False),
                          mesh).data is None
        whole_over_model = path[-1] in ("router", "wB", "wC", "conv_B",
                                        "conv_C")
        assert place.sum_model == (whole_over_model or path[-1] in (
            "ln1", "ln2", "ln_f")), (path, place)
        assert leaf_place(path, fsdp, (2, 1)).sum_model is False


def test_model_axis_refusals():
    """Every FULL and SMOKE config of the four families takes every ``M``
    from 2 to 16, llama4-maverick's 40 attention heads at 16 too (blocks of
    3, the last two ranks empty): experts and SSM heads that ``M`` does
    not divide go in ceil blocks, as a ``d_ff`` or heads do."""
    for arch in FAMILIES:
        for smoke in (False, True):
            cfg = get_config(arch, smoke=smoke)
            for m in range(1, 17):
                check_model_axis(cfg, m)
    moe = get_config("dbrx-132b", smoke=True)
    check_model_axis(dataclasses.replace(moe, n_heads=8, n_kv_heads=8,
                                         head_dim=16), 8)
    hybrid = get_config("zamba2-7b", smoke=True)
    check_model_axis(dataclasses.replace(hybrid, d_ff=126), 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_one_device_and_reference(axis, single, arch):
    rows = [r[f"serve/{arch}"] for r in axis["results"]]
    assert all(row["shard_is_init"] for row in rows)
    for row in rows:
        close(row["logits"], single[arch]["logits"])
    close(rows[0]["logits"], axis["refs"][arch])
    close(single[arch]["logits"], axis["refs"][arch])


@pytest.mark.parametrize("arch", ("dbrx-132b", "llama4-maverick-400b-a17b",
                                  "dbrx-132b+dispatch"))
def test_routes_equal_on_every_rank_and_one_device(axis, single, arch):
    want = single[arch]["routes"]
    cfg = ranks.axis_config(arch)
    assert len(want) == cfg.n_layers
    for r in axis["results"]:
        got = r[f"serve/{arch}"]["routes"]
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_one_device(axis, single, arch):
    cfg = ranks.axis_config(arch)
    for r in axis["results"]:
        row = r[f"serve/{arch}"]
        close(row["prefill"], single[arch]["prefill"])
        assert row["decode"].shape[1] == DECODE
        close(row["decode"], single[arch]["decode"])
        if cfg.family in ("ssm", "hybrid"):
            L, K = cfg.n_layers, cfg.ssm_conv
            assert row["ssm"] == (
                (L, B, cfg.ssm_heads // 2, cfg.ssm_headdim, cfg.ssm_state),
                (L, B, K - 1, cfg.d_inner // 2 + 2 * cfg.ssm_state))
        if cfg.family != "ssm":
            assert row["kv_heads"] == cfg.n_kv_heads // 2


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_device_checkpoint_restores_at_1x2(axis, arch):
    one = axis["ones"][arch]
    for r in axis["results"]:
        got = r[f"restored/{arch}"]
        assert got["step"] == 2
        for x, y in zip(tree_leaves(got["params"]) + tree_leaves(
                got["state"]), tree_leaves(one["params"]) + tree_leaves(
                one["state"])):
            assert torch.equal(x, y)
