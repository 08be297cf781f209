"""Data-parallel training over a world's ranks (gloo, the CPU): the launcher's
``--mesh D``, ZeRO-1 checkpoints and elastic restore.

* ``python -m repro_torch.launch.train --mesh 2 --smoke --device cpu`` on
  one dense (granite-20b), one MoE (dbrx-132b) and one SSM (mamba2-2.7b)
  SMOKE config, three steps of ``synthetic_batch`` (B=4, S=64): its last
  loss within ``rtol = 1e-5`` (the train gate of
  ``tests/test_torch_train.py``) of the port's one-device
  ``microbatch=2`` step, and of the JAX package's jitted
  ``build_train_step(microbatch=2)`` without a mesh from the same weights
  (``lm_params_to_reference``) under the launcher's optimizer.  A world
  step of ``W`` ranks is the reference's ``microbatch=W`` step: the MoE
  family's ``lb_loss`` and capacity depend on which rows sit together;
* the crash at step 3 of a ``--mesh 2`` run (every rank, and the launcher,
  exit 17) and its restart at ``W=2``: the last loss bit for bit;
* elastic restore of the ``W=2`` checkpoint of step 3: at ``W=1`` (with
  ``microbatch=2``) and at ``W=4``, the step-4 loss within ``1e-5`` of the
  one-device run with the same row blocks; the JAX package's
  ``restore_checkpoint`` reads it (every leaf fp32) and gets the port's
  one-device restore of it exactly;
* ``--mesh 2x2`` (the model axis) runs for granite-20b, mamba2-2.7b and
  dbrx-132b SMOKE (the expert axis, ``d_inner`` cut over ``model``), each
  last loss within ``1e-5`` of the one-device ``microbatch=2`` run and of
  the JAX package's step; ``--mesh 2x2x2`` is refused.

The launchers run as subprocesses started together, the worlds through
``run_world`` (their timeouts bound them); ranks run one thread each.
"""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.ckpt import restore_checkpoint as jax_restore_checkpoint
from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.models import build_model as jax_build_model
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.train import build_train_step as jax_build_train_step

from repro_torch.ckpt import restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_to_reference
from repro_torch.launch.train import opt_config_for, parse_mesh, run, train
from repro_torch.models import build_model
from repro_torch.optim import adamw_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-20b", "dbrx-132b", "mamba2-2.7b")
STEPS, BATCH, SEQ = 3, 4, 64
RTOL = 1e-5


def exact(out: str) -> float:
    return float([ln.split("exact")[1] for ln in out.splitlines()
                  if "exact" in ln][-1])


@pytest.fixture(scope="module")
def launched():
    """``--mesh 2`` launchers of the three configs, started together."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--batch", str(BATCH), "--seq", str(SEQ), "--steps",
         str(STEPS), "--device", "cpu", "--mesh", "2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in ARCHS}
    out = {}
    try:
        for arch, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            out[arch] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


def one_device(arch, steps=STEPS, microbatch=2, ckpt=""):
    """The launcher's loop on one device: the last logged loss."""
    return train(None, arch, steps, True, BATCH, SEQ, ckpt,
                 microbatch=microbatch, device="cpu")[2][-1][1]


def reference_loss(arch) -> float:
    """The JAX package's jitted ``microbatch=2`` step from the port's
    ``init(0)`` weights under the launcher's optimizer: the loss of step
    ``STEPS``."""
    cfg = get_config(arch, smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    oc = opt_config_for(cfg, STEPS)
    jcfg = JaxOptConfig(**{f: getattr(oc, f) for f in
                           oc.__dataclass_fields__})
    jp = jax.tree.map(jnp.asarray, lm_params_to_reference(params))
    jo, _ = jax_adamw_init(jp, jax.tree.map(lambda _: P(), jp), jcfg)
    jstep = jax.jit(jax_build_train_step(
        jax_build_model(jax_get_config(arch, smoke=True)), jcfg,
        microbatch=2))
    dcfg = JaxDataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    for step in range(STEPS):
        jp, jo, met = jstep(jp, jo, {k: jnp.asarray(v) for k, v in
                                     jax_synthetic_batch(dcfg, step).items()})
    return float(met["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh2_launcher_equals_one_device_and_reference(launched, arch):
    rc, stdout, stderr = launched[arch]
    assert rc == 0, stderr[-3000:]
    got = exact(stdout)
    assert stdout.count("exact") == 1              # rank 0 alone prints
    np.testing.assert_allclose(got, one_device(arch), rtol=RTOL)
    np.testing.assert_allclose(got, reference_loss(arch), rtol=RTOL)


@pytest.fixture(scope="module")
def crashed(tmp_path_factory):
    """mamba2 at ``--mesh 2``: four steps straight; three, a crash, and the
    restart; the step-3 checkpoint kept for the elastic restores."""
    root = tmp_path_factory.mktemp("train_world")
    kw = dict(arch="mamba2-2.7b", smoke=True, batch=BATCH, seq=SEQ,
              device="cpu", mesh="2")
    gold = run(steps=4, ckpt_dir=str(root / "gold"), **kw)[2]
    with pytest.raises(SystemExit) as e:
        run(steps=4, ckpt_dir=str(root / "ft"), simulate_failure=3, **kw)
    saved = str(root / "w2")
    shutil.copytree(root / "ft", saved)
    resumed = run(steps=4, ckpt_dir=str(root / "ft"), **kw)[2]
    return dict(gold=gold, code=e.value.code, resumed=resumed, saved=saved,
                root=root)


def test_crash_and_restart_at_w2_are_bit_exact(crashed):
    assert crashed["code"] == 17
    assert crashed["resumed"][-1] == crashed["gold"][-1]
    assert sorted(os.listdir(crashed["saved"])) == ["step_000000003"]


@pytest.mark.parametrize("size", (1, 4))
def test_elastic_restore_of_a_w2_checkpoint(crashed, size):
    """Step 4 from the ``W=2`` checkpoint of step 3, at ``W=1``
    (``microbatch=2``) and at ``W=4``, against the one-device run whose
    step 4 takes the same row blocks."""
    ckpt = str(crashed["root"] / f"to{size}")
    shutil.copytree(crashed["saved"], ckpt)
    got = run("mamba2-2.7b", 4, True, BATCH, SEQ, ckpt,
              microbatch=2 if size == 1 else 0, device="cpu",
              mesh=str(size))[2][-1][1]
    base = str(crashed["root"] / f"base{size}")
    one_device("mamba2-2.7b", steps=3, ckpt=base)
    want = one_device("mamba2-2.7b", steps=4, ckpt=base,
                      microbatch=2 if size == 1 else 4)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_reference_restores_a_w2_checkpoint(crashed):
    cfg = get_config("mamba2-2.7b", smoke=True)
    params = build_model(cfg).init(1, device="cpu")
    like = {"params": params,
            "opt": adamw_init(params, opt_config_for(cfg, 4))}
    ours, step = restore_checkpoint(crashed["saved"], like, device="cpu")
    ref_like = jax.tree.map(jnp.asarray, lm_params_to_reference(like))
    theirs, ref_step = jax_restore_checkpoint(crashed["saved"], ref_like)
    assert step == ref_step == 3
    want = lm_params_to_reference(ours)
    for x, y in zip(jax.tree.leaves(want), jax.tree.leaves(theirs)):
        assert np.asarray(y).dtype == x.dtype
        np.testing.assert_array_equal(np.asarray(y), x)


def test_a_model_axis_is_refused():
    """``--mesh`` takes ``D`` or ``DxM`` and refuses a third axis; the
    model axis runs for an attention, the SSM and the MoE family, each
    held to one device's ``microbatch=2`` run and to the reference."""
    assert parse_mesh("2x2") == (2, 2)
    assert parse_mesh("2") == parse_mesh("2x1") == (2, 1)
    with pytest.raises(ValueError, match="D or DxM"):
        parse_mesh("2x2x2")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

    def launch(arch):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             arch, "--smoke", "--batch", str(BATCH), "--seq", str(SEQ),
             "--steps", str(STEPS), "--device", "cpu", "--mesh", "2x2"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    procs = {arch: launch(arch) for arch in
             ("granite-20b", "mamba2-2.7b", "dbrx-132b")}
    out = {arch: p.communicate(timeout=300) + (p.returncode,)
           for arch, p in procs.items()}
    for arch, (stdout, stderr, rc) in out.items():
        assert rc == 0, (arch, stderr[-3000:])
        got = exact(stdout)
        assert stdout.count("exact") == 1          # rank 0 alone prints
        np.testing.assert_allclose(got, one_device(arch), rtol=RTOL)
        np.testing.assert_allclose(got, reference_loss(arch), rtol=RTOL)
