"""The port's training path against the JAX package's, at smoke size in
float32 on the CPU.

The JAX ``build_train_step`` is jitted without a mesh (its launcher's
mesh path fails on this JAX; ROADMAP.md, Queue 3) and stepped three times
beside the port's step, from the same weights and ``synthetic_batch``
batches.  The port runs free beside it, and its loss at every step must be
within ``rtol = 1e-5``.  Each step is also taken by the port from the JAX
package's state before it (carried across with ``lm_params_from_reference``
and ``opt_state_from_reference``): its loss, gradient norm and learning
rate within ``rtol = 1e-5``, and

* every parameter and optimizer leaf after it: float32 leaves within ``1e-5 *
  |ref| + 1e-5 * max |leaf|``, bfloat16 leaves (the factored ``m``) within
  one bf16 ulp (``2**-7 * max(|a|, |b|) + 1e-5 * max |leaf|``: the two
  packages' fp32 moments may round to bf16 on either side of a
  midpoint);
* the exception Adam makes: where a gradient is near zero, its update
  ``m / (sqrt(v) + eps)`` amplifies the packages' last-bit differences
  (up to a flipped sign).  Entries of the parameters (and fp32 masters)
  outside the tolerance are counted; they must be fewer than
  ``ADAM_SHARE`` of all entries, and none may move more than Adam's
  largest step, ``2 * lr`` a step.  The moments get no exception.

Also: ``cross_entropy`` over chunks and a remainder, remat on against off
(gradients bit for bit), the SSD's gradient finite where the JAX
function's is NaN, the flash kernel refused under autograd as the
JAX package's ``jax.grad`` fails on it, and the launcher's crash and
restart (a subprocess on the CPU) ending on the uninterrupted run's loss
bit for bit.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import synthetic_batch as jax_synthetic_batch
from repro.models import build_model as jax_build_model
from repro.optim import OptConfig as JaxOptConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.train import build_train_step as jax_build_train_step
from repro.train import cross_entropy as jax_cross_entropy

from repro_torch.configs import get_config
from repro_torch.interop import (lm_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train import build_train_step, cross_entropy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
ADAM_SHARE = 1e-3
LR = 3e-4
# (arch, microbatch, factored)
RUNS = [("granite-20b", 0, False), ("mamba2-2.7b", 0, False),
        ("dbrx-132b", 0, False), ("granite-20b", 2, False),
        ("granite-20b", 0, True), ("dbrx-132b", 2, True)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: (tree.float().numpy(), tree.dtype == torch.bfloat16)}
    a = np.asarray(tree)
    return {prefix: (a.astype(np.float32), a.dtype.name == "bfloat16")}


def _compare(ref, got) -> tuple:
    """(entries outside the tolerance in parameters/masters, entries in
    all); fails on any moment outside it and on any parameter entry that
    moved more than Adam can move it."""
    want, have = _flat(ref), _flat(got)
    assert want.keys() == have.keys(), set(want) ^ set(have)
    off = total = 0
    for key, (w, bf16) in want.items():
        h = have[key][0]
        assert h.shape == w.shape, key
        diff = np.abs(h - w)
        floor = 1e-5 * np.abs(w).max()
        if bf16:
            ulp = 2.0 ** -7 * np.maximum(np.abs(h), np.abs(w))
            bad = diff > ulp + floor
        else:
            bad = diff > 1e-5 * np.abs(w) + floor
        total += w.size
        if not bad.any():
            continue
        is_param = key.startswith("/params") or "/master/" in key
        assert is_param, (f"{key}: {int(bad.sum())} entries off, worst "
                          f"{diff.max()}")
        assert diff.max() <= 2 * LR + 1e-6, (key, diff.max())
        off += int(bad.sum())
    return off, total


def _run_pair(arch, microbatch, factored, steps=STEPS, batch=4, seq=64):
    """Yields, after each step: the JAX package's (params, state,
    metrics), the port's free-running (params, state, metrics), and the
    port's step taken from the JAX package's previous params and state."""
    jcfg = jax_get_config(arch, smoke=True)
    jm = jax_build_model(jcfg)
    jp, js = jm.init(jax.random.PRNGKey(0))
    jo, _ = jax_adamw_init(jp, js, JaxOptConfig(warmup=1, factored=factored))
    jstep = jax.jit(jax_build_train_step(
        jm, JaxOptConfig(warmup=1, factored=factored), microbatch=microbatch))
    tm = build_model(get_config(arch, smoke=True))
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    oc = OptConfig(warmup=1, factored=factored)
    to = adamw_init(tp, oc)
    assert set(to) == set(jo)
    assert to["step"].dtype == torch.int32 and to["step"].ndim == 0
    tstep = build_train_step(tm, oc, microbatch=microbatch)
    dcfg = JaxDataConfig(vocab=jcfg.vocab, seq_len=seq, global_batch=batch)
    for step in range(steps):
        nb = jax_synthetic_batch(dcfg, step)
        synced = tstep(
            lm_params_from_reference(jax.tree.map(np.asarray, jp),
                                     device="cpu"),
            opt_state_from_reference(jax.tree.map(np.asarray, jo),
                                     device="cpu"),
            {k: torch.from_numpy(v) for k, v in nb.items()})
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v)
                                      for k, v in nb.items()})
        tp, to, tmet = tstep(tp, to, {k: torch.from_numpy(v)
                                      for k, v in nb.items()})
        yield (jp, jo, jmet), (tp, to, tmet), synced


@pytest.mark.parametrize("arch,microbatch,factored", RUNS)
def test_train_steps_match_reference(arch, microbatch, factored):
    """The losses of three free-running steps; each step's leaves, taken
    from the JAX package's state before it (so one step's Adam exceptions
    do not move the next step's gradients)."""
    off = total = 0
    for step, ((jp, jo, jmet), (tp, to, tmet), synced) in enumerate(
            _run_pair(arch, microbatch, factored), start=1):
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {step}")
        sp, so, smet = synced
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(smet[name]), float(jmet[name]),
                                       rtol=1e-5, err_msg=f"{name}, {step}")
        assert int(to["step"]) == int(so["step"]) == int(jo["step"]) == step
        o, t = _compare({"params": jax.tree.map(np.asarray, jp),
                         "opt": jax.tree.map(np.asarray, jo)},
                        {"params": sp, "opt": so})
        off, total = off + o, total + t
    assert off <= ADAM_SHARE * total, (off, total)


def test_train_step_lowers_the_loss_and_keeps_dtypes():
    """A bf16 model (SMOKE in bf16, remat on, master copies in fp32): the
    params keep their dtypes and the masters stay fp32; the loss falls over
    a few steps on the copy-structured stream."""
    cfg = get_config("granite-20b", smoke=True, dtype="bfloat16",
                     remat=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    oc = OptConfig(lr=3e-3, warmup=1)
    state = adamw_init(params, oc)
    step = build_train_step(model, oc)
    dcfg = JaxDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    losses = []
    for s in range(6):
        batch = {k: torch.from_numpy(v)
                 for k, v in jax_synthetic_batch(dcfg, s % 2).items()}
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert params["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert state["master"]["layers"]["attn"]["wq"].dtype == torch.float32
    assert not any(p.requires_grad for p in tree_leaves(params))


@pytest.mark.parametrize("S", [100, 512, 1100])
def test_cross_entropy_matches_reference(S):
    """One chunk, exactly one chunk, and two chunks plus a remainder of
    76 positions: the same sum order as the JAX function's scan."""
    rng = np.random.default_rng(S)
    logits = (3 * rng.standard_normal((2, S, 130))).astype(np.float32)
    labels = rng.integers(0, 130, (2, S)).astype(np.int32)
    want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("arch", ["granite-20b", "zamba2-7b", "dbrx-132b"])
def test_remat_gradients_bit_exact(arch):
    """Gradients with each layer's body under torch.utils.checkpoint equal
    those without, bit for bit (the hybrid's shared block runs inside its
    layer's checkpoint; the MoE router recomputes the same routing)."""
    grads = {}
    for remat in (False, True):
        cfg = get_config(arch, smoke=True, remat=remat)
        model = build_model(cfg)
        params = model.init(3, device="cpu")
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (2, 48)).astype(np.int32))
        logits, aux = model.forward(params, {"tokens": toks})
        loss = cross_entropy(logits, toks) + 0.01 * aux["lb_loss"]
        grads[remat] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["granite-20b", "zamba2-7b"])
def test_remat_only_where_autograd_records(arch, monkeypatch):
    """With grad mode on (nothing turns it off for serving), a forward over
    weights that need no gradient never calls torch.utils.checkpoint, and
    gives the remat-off forward's logits; with weights that need one, every
    layer's body goes through it."""
    from repro_torch.models import transformer as transformer_mod
    calls = []

    def spy(fn, *args, **kw):
        calls.append(fn)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(transformer_mod, "checkpoint", spy)
    cfg = get_config(arch, smoke=True, remat=True)
    model = build_model(cfg)
    params = model.init(3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 48)).astype(np.int32))
    assert torch.is_grad_enabled()
    logits, _ = model.forward(params, {"tokens": toks})
    assert calls == []
    plain, _ = build_model(get_config(arch, smoke=True, remat=False)
                           ).forward(params, {"tokens": toks})
    assert torch.equal(logits, plain)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    model.forward(params, {"tokens": toks})
    assert len(calls) == cfg.n_layers


def test_ssd_gradient_finite_where_the_decay_overflows():
    """At full width the SSD's within-chunk decays overflow above the
    diagonal.  The JAX function masks after the exp, so its gradient is
    0 * inf = NaN there; the port masks the exponent, so its forward is
    the JAX one's and its gradient is finite.  SMOKE mamba2 with ``A_log``
    raised by 6 (decays of e^-100 a step) makes the overflow."""
    jcfg = jax_get_config("mamba2-2.7b", smoke=True)
    jm = jax_build_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    jp["layers"]["mix"]["A_log"] = jp["layers"]["mix"]["A_log"] + 6.0
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 64)) \
        .astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    want, _ = jm.forward(jp, batch)
    jgrads = jax.grad(lambda p: jm.forward(p, batch)[0].mean())(jp)
    assert not all(bool(jnp.isfinite(g).all())
                   for g in jax.tree.leaves(jgrads))
    tm = build_model(get_config("mamba2-2.7b", smoke=True))
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    grads = torch.autograd.grad(got.mean(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_flash_kernel_is_refused_under_autograd():
    """The JAX package cannot differentiate its flash kernel (``jax.grad``
    fails inside ``pallas_call``), so the port raises rather than train
    through other ops; without autograd the forward runs as before."""
    jcfg = jax_get_config("granite-20b", smoke=True, attn_impl="pallas")
    jm = jax_build_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (1, 16)) \
        .astype(np.int32)
    with pytest.raises(Exception):
        jax.grad(lambda p: jm.forward(p, {"tokens": jnp.asarray(toks)})[0]
                 .astype(jnp.float32).mean())(jp)
    cfg = get_config("granite-20b", smoke=True, attn_impl="pallas")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = {"tokens": torch.from_numpy(toks), "labels":
             torch.from_numpy(toks)}
    step = build_train_step(model, OptConfig())
    with pytest.raises(NotImplementedError, match="Queue 1, item 12"):
        step(params, adamw_init(params, OptConfig()), batch)
    with torch.no_grad():
        assert torch.isfinite(model.forward(params, batch)[0]).all()


def _train(ckpt, *extra, steps=6, arch="mamba2-2.7b", seq=64):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           arch, "--smoke", "--batch", "4", "--seq", str(seq),
           "--steps", str(steps), "--ckpt-dir", ckpt, "--device", "cpu",
           *extra]
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)


def _exact_losses(out: str):
    return [line.split("exact")[1].strip() for line in out.splitlines()
            if "exact" in line]


def test_launch_train_crash_restart_bitexact(tmp_path):
    """6 steps, against 3 steps + a hard crash (exit 17 after the save) +
    a restart from the newest manifest: the last loss bit for bit."""
    gold = _train(str(tmp_path / "gold"))
    assert gold.returncode == 0, gold.stderr
    crash = _train(str(tmp_path / "ft"), "--simulate-failure", "3")
    assert crash.returncode == 17, (crash.returncode, crash.stderr)
    assert "simulated failure at step 3" in crash.stdout
    resume = _train(str(tmp_path / "ft"))
    assert resume.returncode == 0, resume.stderr
    assert "resumed from step 3" in resume.stdout
    assert _exact_losses(gold.stdout)[-1] == _exact_losses(resume.stdout)[-1]
    assert sorted(os.listdir(tmp_path / "ft")) == ["step_000000003",
                                                   "step_000000006"]


def test_launch_train_refuses_a_mesh(tmp_path):
    """A model axis (``DxM``, ``M > 1``) runs for every family: granite-20b,
    mamba2-2.7b and dbrx-132b SMOKE at ``--mesh 2x2`` exit 0 with one
    logged loss (held to one device in ``tests/test_torch_train_world.py``),
    and so does one that the heads do not split (granite's 4 at ``--mesh
    1x3``, 2/2/0; held to one device in
    ``tests/test_torch_model_axis_uneven.py``), and so does one that the
    SSM heads do not split (mamba2's 8 at ``--mesh 1x3``, 3/3/2; held to
    one device in ``tests/test_torch_model_axis_experts_heads.py``):
    nothing is refused."""
    for arch in ("granite-20b", "mamba2-2.7b", "dbrx-132b"):
        r = _train(str(tmp_path / arch), "--mesh", "2x2", steps=1, arch=arch)
        assert r.returncode == 0, r.stderr[-3000:]
        assert len(_exact_losses(r.stdout)) == 1
    r = _train(str(tmp_path / "odd"), "--mesh", "1x3", steps=1,
               arch="granite-20b", seq=48)
    assert r.returncode == 0, r.stderr[-3000:]
    assert len(_exact_losses(r.stdout)) == 1
    r = _train(str(tmp_path / "ssm"), "--mesh", "1x3", steps=1,
               arch="mamba2-2.7b", seq=48)
    assert r.returncode == 0, r.stderr[-3000:]
    assert len(_exact_losses(r.stdout)) == 1
