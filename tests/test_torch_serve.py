"""The port's serving path against the JAX package's: the prefill step and
the greedy serve loop (``launch/serve.py``), at smoke size in float32.

The JAX package's ``run`` draws its weights and prompts from its own seed; the
test draws the same ones through the JAX package, carries them across, and
holds the port's loop to the JAX loop's tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import ShapeCell as JaxShapeCell
from repro.configs.shapes import make_inputs as jax_make_inputs
from repro.launch.serve import run as jax_run
from repro.models import build_model as jax_build_model
from repro.train import build_prefill_step as jax_build_prefill_step

from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_reference
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.train import build_prefill_step, build_serve_step

ARCHS = ["granite-20b", "deepseek-coder-33b", "nemotron-4-340b",
         "h2o-danube-1.8b", "dbrx-132b", "llama4-maverick-400b-a17b"]
# the SSM, hybrid, enc-dec and vision-prefix families: their prefill batch
# carries patch embeddings or encoder frames, and seamless's serve loop
# runs its encoder first
FAMILIES = ["mamba2-2.7b", "zamba2-7b", "seamless-m4t-medium",
            "paligemma-3b"]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch, impl):
    jm = jax_build_model(jax_get_config(arch, smoke=True, attn_impl=impl))
    jp, _ = jm.init(jax.random.PRNGKey(1))
    tm = build_model(get_config(arch, smoke=True, attn_impl=impl))
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab, (3, 40)) \
        .astype(np.int32)
    want = jax.jit(jax_build_prefill_step(jm))(
        jp, {"tokens": jnp.asarray(toks)})
    got = build_prefill_step(tm)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (3, 1, tm.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_matches_reference(arch, capsys):
    """The JAX ``run``'s greedy tokens, token for token."""
    B, P, G, seed = 2, 8, 6, 3
    want = jax_run(arch, smoke=True, batch=B, prompt_len=P, gen=G, seed=seed)
    jcfg = jax_get_config(arch, smoke=True)
    jp, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(seed))
    prompt = jax_make_inputs(jcfg, JaxShapeCell("serve", P, B, "prefill"),
                             seed=seed)["tokens"]
    tm = build_model(get_config(arch, smoke=True))
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    got, times = serve.generate(
        tm, tp, torch.from_numpy(np.array(prompt)).long(), G)
    assert got.shape == (B, G) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert times["prompt_steps"] == P and times["gen_steps"] == G - 1


def test_first_generated_token_is_the_prefill_argmax():
    """Prefill by stepping and the fused prefill agree on the next token."""
    tm = build_model(get_config("granite-20b", smoke=True))
    tp = tm.init(5, device="cpu")
    toks = torch.randint(0, tm.cfg.vocab, (4, 12),
                         generator=torch.Generator().manual_seed(6))
    logits = build_prefill_step(tm)(tp, {"tokens": toks})
    got, _ = serve.generate(tm, tp, toks, 3)
    assert torch.equal(got[:, 0], logits[:, 0].argmax(-1))
    cache = tm.init_cache(4, 13, device="cpu")
    step = build_serve_step(tm)
    for t in range(12):
        lg, cache = step(tp, cache, toks[:, t:t + 1])
    assert cache["pos"] == 12
    np.testing.assert_allclose(lg.numpy(), logits.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_run_on_cpu_is_seeded(capsys):
    a = serve.run("nemotron-4-340b", smoke=True, batch=2, prompt_len=4,
                  gen=3, seed=7, device="cpu")
    b = serve.run("nemotron-4-340b", smoke=True, batch=2, prompt_len=4,
                  gen=3, seed=7, device="cpu")
    assert a.shape == (2, 3) and (a >= 0).all() and (a < 512).all()
    np.testing.assert_array_equal(a, b)
    assert "[serve] nemotron-4-340b: batch=2 steps=6" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b"])
def test_run_moe_on_cpu(arch, capsys):
    """The serve CLI's ``run`` for the MoE family: every layer routes its
    tokens with the matching router."""
    out = serve.run(arch, smoke=True, batch=2, prompt_len=5, gen=4, seed=1,
                    device="cpu")
    assert out.shape == (2, 4) and (out >= 0).all() and (out < 512).all()
    assert f"[serve] {arch}: batch=2 steps=8" in capsys.readouterr().out


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_step_carries_the_family_inputs(arch, impl):
    """The prefill step on the JAX package's own ``make_inputs`` batch
    (tokens, and paligemma's patch embeddings or seamless's frames)."""
    jcfg = jax_get_config(arch, smoke=True, attn_impl=impl)
    jm = jax_build_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(1))
    tm = build_model(get_config(arch, smoke=True, attn_impl=impl))
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    batch = jax_make_inputs(jcfg, JaxShapeCell("p", 48, 3, "prefill"),
                            seed=2)
    assert ("frontend" in batch) == (arch == "paligemma-3b")
    assert ("enc_frames" in batch) == (arch == "seamless-m4t-medium")
    want = jax.jit(jax_build_prefill_step(jm))(jp, batch)
    got = build_prefill_step(tm)(
        tp, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert got.shape == (3, 1, tm.cfg.vocab)
    tol = 1e-4 if tm.cfg.family in ("ssm", "hybrid") else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_loop_of_the_families_matches_reference(arch, capsys):
    """The JAX ``run``'s greedy tokens, token for token: mamba2 and zamba2
    step their state caches (zamba2 past its window of 32), seamless runs
    ``prefill_encoder`` over the JAX frames first, paligemma steps the text
    part of its prompt (its ``prompt_len`` counts the 8 patch positions,
    which the loop does not step)."""
    B, P, G, seed = 2, 28, 8, 3
    want = jax_run(arch, smoke=True, batch=B, prompt_len=P, gen=G, seed=seed)
    jcfg = jax_get_config(arch, smoke=True)
    jp, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(seed))
    inputs = jax_make_inputs(jcfg, JaxShapeCell("serve", P, B, "prefill"),
                             seed=seed)
    tm = build_model(get_config(arch, smoke=True))
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    frames = inputs.get("enc_frames")
    got, times = serve.generate(
        tm, tp, torch.from_numpy(np.array(inputs["tokens"])).long(), G,
        enc_frames=None if frames is None else torch.from_numpy(
            np.array(frames)))
    assert got.shape == (B, G)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert times["prompt_steps"] == inputs["tokens"].shape[1]
    if arch == "seamless-m4t-medium":
        with pytest.raises(ValueError, match="needs its enc_frames"):
            serve.generate(tm, tp, torch.zeros(B, 3, dtype=torch.long), 2)


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_of_the_families_on_cpu_is_seeded(arch, capsys):
    a = serve.run(arch, smoke=True, batch=2, prompt_len=12, gen=3, seed=7,
                  device="cpu")
    b = serve.run(arch, smoke=True, batch=2, prompt_len=12, gen=3, seed=7,
                  device="cpu")
    assert a.shape == (2, 3) and (a >= 0).all() and (a < 512).all()
    np.testing.assert_array_equal(a, b)
    steps = 12 - (8 if arch == "paligemma-3b" else 0) + 2
    assert f"[serve] {arch}: batch=2 steps={steps}" in \
        capsys.readouterr().out
