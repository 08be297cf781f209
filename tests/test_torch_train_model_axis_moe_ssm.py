"""Training over a world of 2 x 2 ranks (gloo, the CPU) for the MoE, SSM
and hybrid families at SMOKE size in fp32, each with its FULL config's
``fsdp`` and ``remat``: dbrx-132b and llama4-maverick train under FSDP
over ``data``, sequence parallelism and the expert axis over ``model``
(dbrx also under ``opt_moe_dispatch``, FSDP on the experts' ``d_ff``);
mamba2-2.7b and zamba2-7b under tensor parallelism (``d_inner`` and the
SSM heads cut, the hybrid's shared block by heads and ``d_ff``; zamba2
also with ``fsdp``: FSDP over ``data`` of the mamba and shared blocks,
sequence parallelism through both), every layer under
``torch.utils.checkpoint``.

* three steps of ``synthetic_batch`` (B=4, S=64) under the factored
  optimizer branch (``OptConfig(factored=True)``): the losses within the
  train gate (``rtol = 1e-5``) of the port's one-device ``microbatch=2``
  steps, equal on the four ranks, and the last within the gate of the JAX
  package's jitted ``build_train_step(microbatch=2)`` without a mesh from
  the same weights; every parameter and optimizer leaf, gathered whole,
  within ``atol = 1e-5`` of one device's;
* the first step's gradients as the optimizer takes them (summed over
  ``model`` where a leaf is whole on every model rank, reduced over
  ``data``), gathered whole, within ``atol = 1e-5`` of one device's mean
  over its two microbatches, the ``router`` (each rank's part through its
  own experts' combine weights, the load-balance loss counted once), the
  SSM's ``wB`` and gated-norm ``norm`` named;
* the ``2x2`` save restored on one device (``2x2 -> 1``), leaf for leaf
  bit for bit against the world's own leaves.

The world runs through ``run_world`` (its timeout bounds it); the JAX
steps run in this process meanwhile.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_world_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.train import build_train_step as jax_build_train_step

from repro_torch.ckpt import restore_checkpoint
from repro_torch.distributed import run_world
from repro_torch.interop import lm_params_to_reference
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.optim import OptConfig, adamw_init

ARCHS = ranks.MOE_SSM_ARCHS + ("dbrx-132b+dispatch", "zamba2-7b+fsdp")
STEPS, BATCH, SEQ = 3, 4, 64
FACTORED = dict(factored=True, master_fp32=False, warmup=2)
RTOL = 1e-5


def reference_loss(arch) -> float:
    """The JAX package's jitted ``microbatch=2`` step from the port's
    ``init(0)`` weights under the factored optimizer: the loss of step
    ``STEPS``."""
    cfg = ranks.axis_config(arch)
    params = build_model(cfg).init(0, device="cpu")
    jcfg = JaxOptConfig(**FACTORED)
    jp = jax.tree.map(jnp.asarray, lm_params_to_reference(params))
    jo, _ = jax_adamw_init(jp, jax.tree.map(lambda _: P(), jp), jcfg)
    jstep = jax.jit(jax_build_train_step(jax_build_model(jax_get_config(
        arch.split("+")[0], smoke=True, fsdp=cfg.fsdp, remat=cfg.remat,
        opt_moe_dispatch=cfg.opt_moe_dispatch)), jcfg, microbatch=2))
    for step in range(STEPS):
        batch = ranks.axis_batch(cfg, step, BATCH, SEQ)
        jp, jo, met = jstep(jp, jo, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    return float(met["loss"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_model_axis_moe_ssm")
    ckpts = {a: str(root / a.replace("+", "_")) for a in ARCHS}
    jobs = [(a, "axis_train", (a, STEPS, BATCH, SEQ, FACTORED, ckpts[a], 0,
                               False, True)) for a in ARCHS]
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_world, ranks.axis_suite, 4, jobs, device="cpu",
                        mesh=(2, 2), timeout=300)
        refs = {a: reference_loss(a) for a in ARCHS}
        results = fut.result()
    single = {a: ranks.axis_train(None, a, STEPS, BATCH, SEQ, FACTORED,
                                  microbatch=2, grads=True) for a in ARCHS}
    return dict(results=results, refs=refs, ckpts=ckpts, single=single)


def close(got, want):
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_steps_equal_one_device_and_reference(trained, arch):
    rows = [r[arch] for r in trained["results"]]
    assert all(r["losses"] == rows[0]["losses"] for r in rows)
    want = trained["single"][arch]
    got = rows[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    np.testing.assert_allclose(got["losses"][-1], trained["refs"][arch],
                               rtol=RTOL)
    for x, y in zip(tree_leaves(got["params"]) + tree_leaves(got["state"]),
                    tree_leaves(want["params"]) + tree_leaves(want["state"])):
        assert x.shape == y.shape and x.dtype == y.dtype
        close(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_gradients_equal_one_device(trained, arch):
    want = trained["single"][arch]["grads"]
    cfg = ranks.axis_config(arch)
    for r in trained["results"]:
        got = r[arch]["grads"]
        named = ([got["layers"]["ffn"]["router"]] if cfg.family == "moe"
                 else [got["layers"]["mix"]["wB"],
                       got["layers"]["mix"]["norm"]])
        wanted = ([want["layers"]["ffn"]["router"]] if cfg.family == "moe"
                  else [want["layers"]["mix"]["wB"],
                        want["layers"]["mix"]["norm"]])
        for x, y in zip(named, wanted):
            assert x.shape == y.shape and float(y.abs().max()) > 0
            close(x, y)
        for x, y in zip(tree_leaves(got), tree_leaves(want)):
            assert x.shape == y.shape
            close(x, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_checkpoint_restores_at_1(trained, arch):
    world = trained["results"][0][arch]
    mine = tree_leaves(world["params"]) + tree_leaves(world["state"])
    cfg = ranks.axis_config(arch)
    params = build_model(cfg).init(1, device="cpu")
    like = {"params": params, "opt": adamw_init(params,
                                                OptConfig(**FACTORED))}
    one, step = restore_checkpoint(trained["ckpts"][arch], like,
                                   device="cpu")
    assert step == STEPS
    got = tree_leaves(one["params"]) + tree_leaves(one["opt"])
    assert len(got) == len(mine)
    for x, y in zip(got, mine):
        assert torch.equal(x, y)
