"""The model axis over a world of 1 x 2 ranks (gloo, the CPU), for the six
attention families at SMOKE size in fp32, each with its FULL config's
``fsdp`` and ``remat`` (granite-20b, deepseek-coder-33b and
nemotron-4-340b run under sequence parallelism; granite's and paligemma's
one K/V head is replicated over ``model``; seamless's vocab is cut over
its padded length).

* the placement (``models.common.leaf_place``) against the JAX package's
  specs: the dim ``model`` cuts and the dim ``fsdp_spec`` gives ``data``,
  leaf for leaf, over a 2 x 2 mesh (K/V heads that ``M`` does not divide:
  whole, where the reference moves the axis to ``head_dim``); a model axis
  that does not divide the heads or K/V heads is taken (blocks of
  ``ceil(H / M)``; worlds of such axes are
  ``test_torch_model_axis_uneven.py``'s), and so is every model axis of
  every architecture from 2 to 16 (the MoE, SSM and hybrid families over
  the model axis are ``test_torch_model_axis_moe_ssm.py``'s and
  ``test_torch_model_axis_experts_heads.py``'s);
* each rank's ``init`` its slices of the one-device init bit for bit
  (``Model.shard``); the forward's logits (gathered over ``model``)
  against the port's one device within ``rtol = atol = 1e-5``, and against the JAX package's
  forward from the same weights (``lm_params_to_reference``) within the
  family tests' fp32 tolerance, ``1e-5``;
* the ``attn_impl="pallas"`` prefill on each rank's local heads (on the
  CPU K4's plain version) and 8 teacher-forced decode steps (the cache
  holding the rank's K/V heads) against one device, ``1e-5``;
* the factored optimizer branch forced (``OptConfig(factored=True)``),
  three steps (B=4, S=64): the losses within the train gate (``rtol =
  1e-5``), every parameter and state leaf within ``atol = 1e-5`` of one
  device's;
* a one-device checkpoint restored into the 1 x 2 world (``1 -> 1x2``) and
  gathered back, leaf for leaf bit for bit;
* each differentiable collective over the model axis (``copy_to``,
  ``reduce_from``, ``gather_from``, ``scatter_to``, ``split_to``) and
  ``all_reduce_max_`` against its one-process function, forward and
  backward, exactly.

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

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed import run_world
from repro_torch.interop import lm_params_to_reference
from repro_torch.models import build_model
from repro_torch.models.common import (check_model_axis, leaf_place,
                                       tree_leaves, tree_map_paths)

ARCHS = ranks.AXIS_ARCHS
B, S, DECODE = 2, 64, 8
TRAIN_B, STEPS = 4, 3
FACTORED = dict(factored=True, master_fp32=False, warmup=2)
TOL = 1e-5


def reference_forward(arch) -> np.ndarray:
    """The JAX package's forward of the port's ``init(0)`` weights."""
    cfg = ranks.axis_config(arch)
    params = build_model(cfg).init(0, device="cpu")
    jm = jax_build_model(jax_get_config(arch, smoke=True, fsdp=cfg.fsdp,
                                        remat=cfg.remat))
    jp = jax.tree.map(jnp.asarray, lm_params_to_reference(params))
    batch = ranks.axis_batch(cfg, 7, B, S)
    logits, _ = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return np.asarray(logits)


@pytest.fixture(scope="module")
def axis(tmp_path_factory):
    root = tmp_path_factory.mktemp("model_axis")
    one = ranks.axis_train(None, "granite-20b", 2, TRAIN_B, S,
                           ckpt=str(root / "one"))
    jobs = [(f"serve/{a}", "axis_serve", (a, B, S, DECODE)) for a in ARCHS]
    jobs += [(f"factored/{a}", "axis_train", (a, STEPS, TRAIN_B, S,
                                              FACTORED)) for a in ARCHS]
    jobs.append(("restored", "axis_restore", ("granite-20b",
                                              str(root / "one"), 2)))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_world, ranks.axis_suite, 2, jobs, device="cpu",
                        mesh=(1, 2), timeout=300)
        refs = {a: reference_forward(a) for a in ARCHS}
        results = fut.result()
    return dict(results=results, refs=refs, one=one)


@pytest.fixture(scope="module")
def single():
    return {a: ranks.axis_serve(None, a, B, S, DECODE) for a in ARCHS}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_placement_follows_reference_specs(arch):
    cfg = ranks.axis_config(arch)
    jm = jax_build_model(jax_get_config(arch, smoke=True, fsdp=True))
    _, specs = jm.init(jax.random.PRNGKey(0))
    flat = {}
    tree_map_paths(lambda path, s: flat.setdefault(path, s), jax.tree.map(
        lambda s: tuple(s), specs,
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
    mesh = (2, 2)
    fsdp = dataclasses.replace(cfg, fsdp=True)
    for path, spec in flat.items():
        place = leaf_place(path, fsdp, mesh)
        want_model = spec.index("model") if "model" in spec else None
        if path[-1] in ("wk", "wv") and cfg.n_kv_heads % 2:
            want_model = None              # replicated: the port's rule
        assert place.model == want_model, (path, spec, place)
        assert place.data == (spec.index("data") if "data" in spec
                              else None), (path, spec, place)
        assert leaf_place(path, dataclasses.replace(cfg, fsdp=False),
                          mesh).data is None


def test_model_axis_refusals():
    """Nothing is refused any more: every architecture, FULL and SMOKE,
    takes every model axis from 2 to 16 (experts and SSM heads in ceil
    blocks too); heads and K/V heads that ``M`` does not divide are
    taken (granite's 4 heads over 3, 6 heads on 3 K/V heads over 2)."""
    for arch in ARCH_NAMES:
        for smoke in (False, True):
            cfg = get_config(arch, smoke=smoke)
            for m in range(2, 17):
                check_model_axis(cfg, m)
    cfg = get_config("granite-20b", smoke=True)
    check_model_axis(cfg, 3)
    odd = dataclasses.replace(cfg, n_heads=6, n_kv_heads=3, head_dim=16)
    check_model_axis(odd, 2)
    check_model_axis(dataclasses.replace(cfg, n_kv_heads=2), 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_one_device_and_reference(axis, single, arch):
    rows = [r[f"serve/{arch}"] for r in axis["results"]]
    assert all(row["shard_is_init"] for row in rows)
    for row in rows:
        close(row["logits"], single[arch]["logits"])
    close(rows[0]["logits"], axis["refs"][arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_pallas_prefill_on_local_heads(axis, single, arch):
    got = axis["results"][0][f"serve/{arch}"]["prefill"]
    assert got.shape == single[arch]["prefill"].shape
    close(got, single[arch]["prefill"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_one_device(axis, single, arch):
    cfg = ranks.axis_config(arch)
    for rank, r in enumerate(axis["results"]):
        row = r[f"serve/{arch}"]
        assert row["decode"].shape[1] == DECODE
        close(row["decode"], single[arch]["decode"])
        want_heads = (cfg.n_kv_heads // 2 if cfg.n_kv_heads % 2 == 0
                      else 1)
        assert row["kv_heads"] == want_heads


@pytest.mark.parametrize("arch", ARCHS)
def test_factored_steps_equal_one_device(axis, arch):
    got = axis["results"][0][f"factored/{arch}"]
    want = ranks.axis_train(None, arch, STEPS, TRAIN_B, S, FACTORED)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    for x, y in zip(tree_leaves(got["params"]) + tree_leaves(got["state"]),
                    tree_leaves(want["params"]) + tree_leaves(want["state"])):
        assert x.shape == y.shape
        close(x.float(), y.float())


def test_one_device_checkpoint_restores_at_1x2(axis):
    one = axis["one"]
    for r in axis["results"]:
        got = r["restored"]
        assert got["step"] == 2
        for x, y in zip(tree_leaves(got["params"]) + tree_leaves(
                got["state"]), tree_leaves(one["params"]) + tree_leaves(
                one["state"])):
            assert torch.equal(x, y)


@pytest.mark.parametrize("op", ranks.COLLECTIVES + ("max",))
def test_model_axis_collectives(axis, op):
    ranks.check_collectives(axis["results"], "model", op)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_root_gather_hands_each_backend_its_tensors(backend, monkeypatch):
    """A save's gather onto rank 0 (``gather_cuts(..., root=True)``) hands
    gloo host tensors (it gathers no card tensor) and NCCL the leaf where
    it lies (it takes no host tensor): a leaf on the ``meta`` device, which
    cannot be copied to the host, reaches NCCL's gather as it is."""
    from repro_torch.distributed import Axis, World
    from repro_torch.distributed import comm
    from repro_torch.models.common import gather_cuts
    seen = []

    def gather(t, dim, axis):
        seen.append((t.device.type, axis.name))
        return torch.cat([t] * axis.size, dim)

    monkeypatch.setattr(comm, "gather_to_first", gather)
    dev = torch.device("meta" if backend == "nccl" else "cpu")
    world = World(rank=0, size=4, backend=backend, devices=(dev,) * 4,
                  ident=-1, mesh=(2, 2),
                  data=Axis("data", 0, 2, (0, 2)),
                  model=Axis("model", 0, 2, (0, 1)))
    leaf = torch.zeros(3, 4, 5, device=dev, requires_grad=True)
    whole = gather_cuts(leaf, ((1, "model", 8, 4), (2, "data", 9, 5)),
                        world, root=True)
    assert tuple(whole.shape) == (3, 8, 9) and whole.device.type == dev.type
    assert seen == [(dev.type, "model"), (dev.type, "data")]
