"""Training over a world of 2 x 2 ranks (gloo, the CPU): the data axis and
the model axis together, for the six attention families at SMOKE size in
fp32, each with its FULL config's ``fsdp`` and ``remat`` (granite-20b,
deepseek-coder-33b and nemotron-4-340b train under FSDP over ``data`` and
sequence parallelism over ``model``, every layer under
``torch.utils.checkpoint``).

* three steps of ``synthetic_batch`` (B=4, S=64; the vision prefix's patch
  embeddings and the enc-dec's frames drawn per step): the last loss
  within the train gate (``rtol = 1e-5``) of the port's one-device
  ``microbatch=2`` step and of the JAX package's jitted
  ``build_train_step(microbatch=2)`` without a mesh from the same weights
  under the launcher's optimizer; every parameter and optimizer leaf,
  gathered whole, within ``atol = 1e-5`` of one device's; the four ranks'
  losses equal;
* the ``2x2`` save (each leaf gathered over both axes, written whole by
  rank 0): restored on one device (``2x2 -> 1``) and into a world of 2
  (``2x2 -> 2``, gathered back), leaf for leaf bit for bit against the
  world's own leaves; the JAX package's ``restore_checkpoint`` reads it
  and gets the port's one-device restore exactly;
* each differentiable collective over both axes of the 2 x 2 world
  against its one-process function, forward and backward; the world of 2
  remeshed as 1 x 2 (``World.remesh``).

The world of 4 and then a world of 2 run through ``run_world`` (their
timeouts bound them); the JAX steps run in this process meanwhile.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_world_ranks as ranks
from repro.ckpt import restore_checkpoint as jax_restore_checkpoint
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.train import build_train_step as jax_build_train_step

from repro_torch.ckpt import restore_checkpoint
from repro_torch.distributed import run_world
from repro_torch.interop import lm_params_to_reference
from repro_torch.launch.train import opt_config_for
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw_init

ARCHS = ranks.AXIS_ARCHS
STEPS, BATCH, SEQ = 3, 4, 64
RTOL = 1e-5


def reference_loss(arch) -> float:
    """The JAX package's jitted ``microbatch=2`` step from the port's
    ``init(0)`` weights under the launcher's optimizer: the loss of step
    ``STEPS``."""
    cfg = ranks.axis_config(arch)
    params = build_model(cfg).init(0, device="cpu")
    oc = opt_config_for(cfg, STEPS)
    jcfg = JaxOptConfig(**{f: getattr(oc, f) for f in
                           oc.__dataclass_fields__})
    jp = jax.tree.map(jnp.asarray, lm_params_to_reference(params))
    jo, _ = jax_adamw_init(jp, jax.tree.map(lambda _: P(), jp), jcfg)
    jstep = jax.jit(jax_build_train_step(jax_build_model(jax_get_config(
        arch, smoke=True, fsdp=cfg.fsdp, remat=cfg.remat)), jcfg,
        microbatch=2))
    for step in range(STEPS):
        batch = ranks.axis_batch(cfg, step, BATCH, SEQ)
        jp, jo, met = jstep(jp, jo, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    return float(met["loss"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_model_axis")
    ckpts = {a: str(root / a) for a in ARCHS}
    jobs = [(a, "axis_train", (a, STEPS, BATCH, SEQ, None, ckpts[a]))
            for a in ARCHS]
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_world, ranks.axis_suite, 4, jobs, device="cpu",
                        mesh=(2, 2), timeout=300)
        refs = {a: reference_loss(a) for a in ARCHS}
        results = fut.result()
    restores = [(a, "axis_restore", (a, ckpts[a], STEPS)) for a in ARCHS]
    restores.append(("remeshed", "axis_remesh", ((1, 2),)))
    in2 = run_world(ranks.axis_suite, 2, restores, device="cpu",
                    mesh=(2, 1), timeout=300)
    return dict(results=results, refs=refs, ckpts=ckpts, in2=in2)


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_steps_equal_one_device_and_reference(trained, arch):
    rows = [r[arch] for r in trained["results"]]
    assert all(r["losses"] == rows[0]["losses"] for r in rows)
    want = ranks.axis_train(None, arch, STEPS, BATCH, SEQ, microbatch=2)
    got = rows[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    np.testing.assert_allclose(got["losses"][-1], trained["refs"][arch],
                               rtol=RTOL)
    for x, y in zip(tree_leaves(got["params"]) + tree_leaves(got["state"]),
                    tree_leaves(want["params"]) + tree_leaves(want["state"])):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   rtol=RTOL, atol=RTOL)


def _like(arch, seed=1):
    cfg = ranks.axis_config(arch)
    params = build_model(cfg).init(seed, device="cpu")
    return {"params": params,
            "opt": adamw_init(params, opt_config_for(cfg, STEPS))}


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_checkpoint_restores_at_1_and_at_2(trained, arch):
    world = trained["results"][0][arch]
    mine = tree_leaves(world["params"]) + tree_leaves(world["state"])
    one, step = restore_checkpoint(trained["ckpts"][arch], _like(arch),
                                   device="cpu")
    assert step == STEPS
    got = tree_leaves(one["params"]) + tree_leaves(one["opt"])
    assert len(got) == len(mine)
    for x, y in zip(got, mine):
        assert torch.equal(x, y)
    for r in trained["in2"]:
        row = r[arch]
        assert row["step"] == STEPS
        for x, y in zip(tree_leaves(row["params"]) + tree_leaves(
                row["state"]), mine):
            assert torch.equal(x, y)


def test_reference_restores_a_2x2_checkpoint(trained):
    arch = "granite-20b"
    like = _like(arch)
    ours, step = restore_checkpoint(trained["ckpts"][arch], like,
                                    device="cpu")
    ref_like = jax.tree.map(jnp.asarray, lm_params_to_reference(like))
    theirs, ref_step = jax_restore_checkpoint(trained["ckpts"][arch],
                                              ref_like)
    assert step == ref_step == STEPS
    want = lm_params_to_reference(ours)
    for x, y in zip(jax.tree.leaves(want), jax.tree.leaves(theirs)):
        assert np.asarray(y).dtype == x.dtype
        np.testing.assert_array_equal(np.asarray(y), x)


def test_a_world_remeshed(trained):
    """The world of 2 (mesh 2 x 1) as 1 x 2: the new world is current, its
    model axis the two ranks, its data axis one."""
    for rank, r in enumerate(trained["in2"]):
        got = r["remeshed"]
        assert got["current"] and got["ident"]
        assert got["data"] == (0, 1, (rank,), float(rank))
        assert got["model"] == (rank, 2, (0, 1), 1.0)


@pytest.mark.parametrize("name", ("data", "model"))
@pytest.mark.parametrize("op", ranks.COLLECTIVES + ("max",))
def test_2x2_collectives(trained, name, op):
    ranks.check_collectives(trained["results"], name, op)
