"""ZeRO-1 over a world's ranks (``repro_torch.optim.adamw``) on the CPU.

* ``zero1_dim`` of every leaf of each SMOKE config at ``W`` = 2, 3 and 4,
  plain and factored: the leaves whose optimizer state stays whole are
  pinned (``WHOLE``; ``ALL``: every leaf), every other leaf is cut along
  the first dim ``W`` divides (not one of a factorable leaf's last two in
  the factored branch); and for the plain branch at ``W`` = 2 and 4 that
  dim is where the JAX package puts the data axis (``_zero1_spec``, then
  ``sanitize_spec`` on a mesh of that size);
* the update over gloo worlds of 2 and 4 ranks, fp32 masters, no masters,
  and the factored state (bf16 params), two steps from per-rank gradients
  reduced as the train step reduces them: the whole params after each step
  and every rank's state slices, joined, against the one-device update
  from the mean gradients, within the optimizer's tolerance (``rtol = atol
  = 1e-6`` for fp32, one bf16 ulp for bf16; ``tests/test_torch_optim.py``),
  the gradient norm and learning rate within ``1e-6``.

One world of each size runs every update (a module fixture; its
``run_world`` timeout bounds it).
"""
import types

import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_world_ranks as ranks
from repro.models.common import sanitize_spec
from repro.optim.adamw import _zero1_spec

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.distributed import run_world
from repro_torch.interop import lm_params_from_reference
from repro_torch.models import build_model
from repro_torch.optim import OptConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import _factorable, zero1_dim

ALL = "every leaf"
WHOLE = {   # (arch, W, factored) -> the leaves kept whole
    ('seamless-m4t-medium', 2, False): (),
    ('seamless-m4t-medium', 2, True): (
        'embed/tok', 'embed/unembed', 'enc/ln1', 'enc/ln2', 'layers/ln1',
        'layers/ln2', 'layers/lnx',
    ),
    ('seamless-m4t-medium', 3, False): ALL,
    ('seamless-m4t-medium', 3, True): ALL,
    ('seamless-m4t-medium', 4, False): (),
    ('seamless-m4t-medium', 4, True): (
        'embed/tok', 'embed/unembed', 'enc/ffn/w_in', 'enc/ffn/w_out',
        'enc/ln1', 'enc/ln2', 'layers/ffn/w_in', 'layers/ffn/w_out',
        'layers/ln1', 'layers/ln2', 'layers/lnx',
    ),
    ('h2o-danube-1.8b', 2, False): (),
    ('h2o-danube-1.8b', 2, True): (
        'embed/tok', 'embed/unembed', 'layers/ln1', 'layers/ln2',
    ),
    ('h2o-danube-1.8b', 3, False): ALL,
    ('h2o-danube-1.8b', 3, True): ALL,
    ('h2o-danube-1.8b', 4, False): (),
    ('h2o-danube-1.8b', 4, True): (
        'embed/tok', 'embed/unembed', 'layers/ffn/w_gate', 'layers/ffn/w_in',
        'layers/ffn/w_out', 'layers/ln1', 'layers/ln2',
    ),
    ('nemotron-4-340b', 2, False): (),
    ('nemotron-4-340b', 2, True): (
        'embed/tok', 'embed/unembed', 'layers/ln1', 'layers/ln2',
    ),
    ('nemotron-4-340b', 3, False): ALL,
    ('nemotron-4-340b', 3, True): ALL,
    ('nemotron-4-340b', 4, False): (),
    ('nemotron-4-340b', 4, True): (
        'embed/tok', 'embed/unembed', 'layers/ffn/w_in', 'layers/ffn/w_out',
        'layers/ln1', 'layers/ln2',
    ),
    ('deepseek-coder-33b', 2, False): (),
    ('deepseek-coder-33b', 2, True): (
        'embed/tok', 'embed/unembed', 'layers/ln1', 'layers/ln2',
    ),
    ('deepseek-coder-33b', 3, False): ALL,
    ('deepseek-coder-33b', 3, True): ALL,
    ('deepseek-coder-33b', 4, False): (),
    ('deepseek-coder-33b', 4, True): (
        'embed/tok', 'embed/unembed', 'layers/ffn/w_gate', 'layers/ffn/w_in',
        'layers/ffn/w_out', 'layers/ln1', 'layers/ln2',
    ),
    ('granite-20b', 2, False): (),
    ('granite-20b', 2, True): (
        'embed/tok', 'embed/unembed', 'layers/ln1', 'layers/ln2',
    ),
    ('granite-20b', 3, False): ALL,
    ('granite-20b', 3, True): ALL,
    ('granite-20b', 4, False): (),
    ('granite-20b', 4, True): (
        'embed/tok', 'embed/unembed', 'layers/ffn/w_in', 'layers/ffn/w_out',
        'layers/ln1', 'layers/ln2',
    ),
    ('zamba2-7b', 2, False): (),
    ('zamba2-7b', 2, True): (
        'embed/tok', 'embed/unembed', 'layers/ln1', 'layers/mix/A_log',
        'layers/mix/Dp', 'layers/mix/dt_bias', 'layers/mix/norm',
        'shared/ffn/w_gate', 'shared/ffn/w_in', 'shared/ffn/w_out',
    ),
    ('zamba2-7b', 3, False): ALL,
    ('zamba2-7b', 3, True): ALL,
    ('zamba2-7b', 4, False): (),
    ('zamba2-7b', 4, True): (
        'embed/tok', 'embed/unembed', 'layers/ln1', 'layers/mix/A_log',
        'layers/mix/Dp', 'layers/mix/dt_bias', 'layers/mix/norm',
        'shared/ffn/w_gate', 'shared/ffn/w_in', 'shared/ffn/w_out',
    ),
    ('llama4-maverick-400b-a17b', 2, False): (),
    ('llama4-maverick-400b-a17b', 2, True): (
        'embed/tok', 'embed/unembed', 'layers/ln1', 'layers/ln2',
    ),
    ('llama4-maverick-400b-a17b', 3, False): ALL,
    ('llama4-maverick-400b-a17b', 3, True): ALL,
    ('llama4-maverick-400b-a17b', 4, False): (),
    ('llama4-maverick-400b-a17b', 4, True): (
        'embed/tok', 'embed/unembed', 'layers/ffn/router',
        'layers/ffn/sh_gate', 'layers/ffn/sh_in', 'layers/ffn/sh_out',
        'layers/ln1', 'layers/ln2',
    ),
    ('dbrx-132b', 2, False): (),
    ('dbrx-132b', 2, True): (
        'embed/tok', 'embed/unembed', 'layers/ln1', 'layers/ln2',
    ),
    ('dbrx-132b', 3, False): ALL,
    ('dbrx-132b', 3, True): ALL,
    ('dbrx-132b', 4, False): (),
    ('dbrx-132b', 4, True): (
        'embed/tok', 'embed/unembed', 'layers/ffn/router', 'layers/ln1',
        'layers/ln2',
    ),
    ('paligemma-3b', 2, False): (),
    ('paligemma-3b', 2, True): (
        'embed/tok', 'layers/ln1', 'layers/ln2', 'vproj',
    ),
    ('paligemma-3b', 3, False): ALL,
    ('paligemma-3b', 3, True): ALL,
    ('paligemma-3b', 4, False): (),
    ('paligemma-3b', 4, True): (
        'embed/tok', 'layers/ffn/w_gate', 'layers/ffn/w_in',
        'layers/ffn/w_out', 'layers/ln1', 'layers/ln2', 'vproj',
    ),
    ('mamba2-2.7b', 2, False): (),
    ('mamba2-2.7b', 2, True): (
        'embed/tok', 'layers/ln1', 'layers/mix/A_log', 'layers/mix/Dp',
        'layers/mix/dt_bias', 'layers/mix/norm',
    ),
    ('mamba2-2.7b', 3, False): ALL,
    ('mamba2-2.7b', 3, True): ALL,
    ('mamba2-2.7b', 4, False): (),
    ('mamba2-2.7b', 4, True): (
        'embed/tok', 'layers/ln1', 'layers/mix/A_log', 'layers/mix/Dp',
        'layers/mix/conv_B', 'layers/mix/conv_C', 'layers/mix/conv_x',
        'layers/mix/dt_bias', 'layers/mix/norm', 'layers/mix/out',
        'layers/mix/wB', 'layers/mix/wC', 'layers/mix/wdt', 'layers/mix/wx',
        'layers/mix/wz',
    ),
}


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


_SMOKE = {}


def smoke_shapes(arch):
    if arch not in _SMOKE:
        params = build_model(get_config(arch, smoke=True)).init(
            0, device="cpu")
        _SMOKE[arch] = {k: tuple(t.shape) for k, t in leaves(params)}
    return _SMOKE[arch]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_zero1_dims_of_smoke_configs_are_pinned(arch):
    shapes = smoke_shapes(arch)
    for size in (2, 3, 4):
        for factored in (False, True):
            dims = {k: zero1_dim(s, size, factored)
                    for k, s in shapes.items()}
            whole = tuple(k for k, d in dims.items() if d is None)
            pinned = WHOLE[(arch, size, factored)]
            assert whole == (tuple(shapes) if pinned == ALL else pinned), (
                size, factored, whole)
            for k, d in dims.items():
                if d is None:
                    continue
                s = shapes[k]
                last = len(s) - (2 if factored and _factorable(s) else 0)
                assert d < last and s[d] % size == 0, (k, s, d)
                assert all(s[i] % size for i in range(d)), (k, s, d)


@pytest.mark.parametrize("size", (2, 4))
def test_zero1_dim_is_the_references_data_axis(size):
    """The plain branch's dim is where the reference's ``_zero1_spec``
    and ``sanitize_spec`` put the data axis on a mesh of ``size``."""
    mesh = types.SimpleNamespace(shape={"data": size})
    shapes = {s for arch in ARCH_NAMES for s in smoke_shapes(arch).values()}
    shapes |= {(6, 8), (3, 5), (12,), (1, 4), (4, 1), (2, 6, 3), ()}
    for s in sorted(shapes):
        spec = sanitize_spec(_zero1_spec(P(), s), s, mesh)
        parts = list(spec) + [None] * (len(s) - len(spec))
        want = parts.index("data") if "data" in parts else None
        assert zero1_dim(s, size) == want, (s, spec)


SHAPES = {"scalar": (), "vec": (12,), "odd": (5, 3), "row": (1, 8),
          "col": (8, 1), "mat": (8, 6), "stack": (4, 3, 6),
          "stack2": (2, 5, 4)}
# (name, params dtype, OptConfig fields)
RUNS = [("master", np.float32, dict(master_fp32=True)),
        ("no_master", np.float32, dict(master_fp32=False)),
        ("factored", ml_dtypes.bfloat16, dict(factored=True,
                                               master_fp32=False))]
STEPS = 2


def draw(rng, dtype=np.float32):
    return {k: rng.standard_normal(s).astype(np.float32).astype(dtype)
            for k, s in SHAPES.items()}


def run_inputs(size):
    """Per run: (params, per step the ranks' gradients, OptConfig
    fields)."""
    out = []
    for i, (_, dtype, kw) in enumerate(RUNS):
        rng = np.random.default_rng(10 * size + i)
        params = draw(rng, dtype)
        grads = [[draw(rng) for _ in range(size)] for _ in range(STEPS)]
        out.append((params, grads, dict(kw, warmup=2, clip_norm=2.0)))
    return out


@pytest.fixture(scope="module", params=(2, 4))
def world(request):
    size = request.param
    inputs = run_inputs(size)
    return size, inputs, run_world(ranks.zero1_suite, size, inputs,
                                   device="cpu", timeout=120)


def close(got: torch.Tensor, want: torch.Tensor, what: str):
    if want.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        ulp = 2.0 ** -7 * torch.maximum(g.abs(), w.abs())
        assert bool(((g - w).abs() <= ulp).all()), what
        return
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6, msg=what)


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_zero1_update_equals_one_device(world, run):
    size, inputs, results = world
    i = [r[0] for r in RUNS].index(run)
    got = [by_rank[i] for by_rank in results]          # rank -> this run
    params, grads, kw = inputs[i]
    cfg = OptConfig(**kw)
    p = lm_params_from_reference(params, device="cpu")
    state = adamw_init(p, cfg)
    pdims = {k: zero1_dim(t.shape, size, cfg.factored)
             for k, t in leaves(p)}
    for step in range(STEPS):
        mean = {k: sum(torch.from_numpy(g[k]) for g in grads[step]) / size
                for k in SHAPES}
        p, state, met = adamw_update(p, mean, state, cfg)
        for rank, out in enumerate(got):
            mine = out["steps"][step]
            for name in ("grad_norm", "lr"):
                np.testing.assert_allclose(mine[name], float(met[name]),
                                           rtol=1e-6)
            for k, t in leaves(p):
                close(dict(leaves(mine["params"]))[k], t,
                      f"{run} step {step} rank {rank} params/{k}")
        for key, t in leaves(state):
            if key == "step":
                assert all(int(o["steps"][step]["state"]["step"]) == step + 1
                           for o in got)
                continue
            leaf = key.split("/", 1)[1]
            d = pdims[leaf]
            if key.startswith("vc/") and not _factorable(SHAPES[leaf]):
                d = None                       # (1,): whole
            parts = [dict(leaves(o["steps"][step]["state"]))[key]
                     for o in got]
            whole = parts[0] if d is None else torch.cat(parts, d)
            if d is None:
                for other in parts[1:]:
                    assert torch.equal(other, parts[0]), key
            close(whole, t, f"{run} step {step} state/{key}")


def test_init_cuts_the_state_and_keeps_whole_leaves_whole():
    """``adamw_init`` over a stand-in world of 4 at rank 2: each state
    leaf is the slice ``rank`` of the one-device leaf along its dim."""
    from repro_torch.distributed import Axis, World
    world = World(rank=2, size=4, backend="gloo",
                  devices=(torch.device("cpu"),) * 4, ident=-1, mesh=(4, 1),
                  data=Axis("data", 2, 4, (0, 1, 2, 3)),
                  model=Axis("model", 0, 1, (2,)))
    p = lm_params_from_reference(draw(np.random.default_rng(0)),
                                 device="cpu")
    for factored in (False, True):
        cfg = OptConfig(factored=factored, master_fp32=not factored)
        whole, mine = adamw_init(p, cfg), adamw_init(p, cfg, world)
        for k, t in leaves(p):
            d = zero1_dim(t.shape, 4, factored)
            m = dict(leaves(mine))[f"m/{k}"]
            want = dict(leaves(whole))[f"m/{k}"]
            if d is not None:
                want = want.chunk(4, d)[2]
            assert torch.equal(m, want), k
            if not factored:
                w = dict(leaves(mine))[f"master/{k}"]
                assert torch.equal(w, t if d is None else t.chunk(4, d)[2])
