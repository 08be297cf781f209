"""Rank functions of the port's world tests (``tests/test_torch_*world*.py``,
``test_torch_zero1.py``).

Each runs in a rank process that ``repro_torch.distributed.run_world``
started, and returns host data (numpy arrays, CPU tensors, numbers), so
that the parent compares.  This module imports neither JAX nor the JAX
package: a rank imports only the port.
"""
import os
import time

import numpy as np
import torch

from repro_torch.distributed import (all_gather_into, all_reduce_min_,
                                     all_reduce_sum_, broadcast_,
                                     reduce_scatter_mean)

FIELDS = ("cmatch", "rmatch", "phases", "fallbacks", "certified")


def outcome(state) -> tuple:
    return tuple(getattr(state, f).cpu().numpy() for f in FIELDS)


# -- repro_torch/distributed --------------------------------------------------
def ranked(world, shape, dtype=torch.float32) -> torch.Tensor:
    """A seeded tensor that differs from rank to rank."""
    g = torch.Generator().manual_seed(1000 + world.rank)
    return (torch.randn(shape, generator=g) * 8).to(dtype)


def collectives(world, device="cpu") -> dict:
    """Every collective of ``comm`` on seeded per-rank inputs on
    ``device``; the results on the CPU."""
    out = {"rank": world.rank, "backend": world.backend}

    def on(t):
        return t.to(device)

    t = on(ranked(world, (37,), torch.int32))
    out["all_reduce_min"] = all_reduce_min_(t, world)
    t = on(ranked(world, (3, 5)))
    out["all_reduce_sum"] = all_reduce_sum_(t, world)
    t = on(ranked(world, (11,)))
    out["broadcast"] = broadcast_(t, world.size - 1, world)
    for dim in (0, 1):
        shape = [2, 3]
        shape[dim] *= world.size
        out[f"reduce_scatter_{dim}"] = reduce_scatter_mean(
            on(ranked(world, tuple(shape))), dim, world)
        piece = on(ranked(world, (2, 3)))
        out[f"all_gather_{dim}"] = all_gather_into(
            on(torch.empty(shape)), piece, dim, world)
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def card_collectives(world) -> dict:
    """:func:`collectives` on the CPU and on this rank's card."""
    return dict(cpu=collectives(world), card=collectives(world,
                                                         world.device))


def fails(world, how: str) -> None:
    """Rank 1 fails ``how``; the others wait in a collective."""
    if world.rank == 1:
        if how == "raise":
            raise ValueError("rank 1 fails on purpose")
        if how == "vanish":
            os._exit(3)
        if how == "exit":
            raise SystemExit(17)
        if how == "hang":
            time.sleep(3600)
    if how == "exit":
        raise SystemExit(17)
    all_reduce_sum_(torch.ones(4), world)


# -- the matcher ----------------------------------------------------------------
def solve_cases(world, cases) -> dict:
    """Each case ``(key, host graph, path, warm start, config overrides,
    (cmatch0, rmatch0) or None)`` through ``ShardedMatcher`` over a mesh of
    the world, from the host graph (each rank uploads its shard): the state
    and the counts."""
    from repro_torch.matching import (SOLVE_PATHS, MatcherConfig,
                                      MatchState, ShardedMatcher, make_mesh)
    mesh = make_mesh((world.size,), ("data",))
    out = {}
    for key, g, path, ws, kw, start in cases:
        cfg = SOLVE_PATHS[path].configure(MatcherConfig(**kw))
        state = None
        if start is not None:
            state = MatchState.from_host(*start, device=world.device)
        m = ShardedMatcher(mesh, "data", cfg, ws)
        got = m.run(g, state)
        out[key] = (outcome(got), dict(m.last_counts))
        if world.device.type == "cuda":
            from repro_torch.kernels.frontier_expand import (LAUNCHES,
                                                             reset_launches)
            reset_launches()
            again = m.run(g, state)                    # warm
            out[key] += (dict(LAUNCHES), outcome(again))
    return out


def distributed_cases(world, g, algos, cm0, rm0) -> dict:
    """``core.distributed.maximum_matching_distributed`` over a mesh of the
    world, resumed from ``(cm0, rm0)``, per algorithm."""
    from repro_torch.core.distributed import maximum_matching_distributed
    from repro_torch.matching import MatcherConfig, make_mesh
    mesh = make_mesh((world.size,), ("data",))
    return {algo: maximum_matching_distributed(
        g, mesh, MatcherConfig(algo=algo, kernel="gpubfs_wr"),
        cmatch0=cm0, rmatch0=rm0) for algo in algos}


def sharded_suite(world, cases_, g, algos, cm0, rm0):
    """``test_torch_sharded_world``'s rank: every case, ``maximum_matching_
    distributed`` and the refusals."""
    from repro_torch.matching import (MatcherConfig, ShardedMatcher,
                                      TorchCSR, make_mesh)
    out = {"cases": solve_cases(world, cases_),
           "dist": distributed_cases(world, g, algos, cm0, rm0)}
    mesh = make_mesh((world.size,), ("data",))
    shard = TorchCSR.from_host(g, device="cpu").shard(mesh, "data")
    errors = {}
    for what, fn in {
            "warm on a shard": lambda: ShardedMatcher(
                mesh, "data", MatcherConfig(), "cheap").run(shard),
            "with_csc of a shard": lambda: shard.with_csc(),
            "mesh of another device": lambda: make_mesh(
                (world.size,), ("data",), devices=["meta"] * world.size,
                world=world)}.items():
        try:
            fn()
            errors[what] = None
        except ValueError as e:
            errors[what] = str(e)
    out["errors"] = errors
    # the whole graph uploaded on every rank (run shards it) against the
    # host graph, each rank uploading its shard only
    cfg = MatcherConfig(dirop=True, use_pallas=True)
    m = ShardedMatcher(mesh, "data", cfg, "cheap")
    out["whole"] = (outcome(m.run(TorchCSR.from_host(
        g, device=world.device).with_csc())), outcome(m.run(g)))
    out["nnz_pad"] = (shard.nnz_pad, shard.shards, len(
        shard.shard_slices("ecol")))
    return out


# -- ZeRO-1 and training ------------------------------------------------------
def _tree_to(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_to(v, fn) for k, v in tree.items()}
    return fn(tree)


def zero1_steps(world, params, grads_by_rank, kw) -> dict:
    """``adamw_update`` over the world from ``params`` (a numpy tree, the
    same on every rank): step ``i`` with rank ``r``'s gradients
    ``grads_by_rank[i][r]`` reduced as the train step reduces them.
    Returns the whole params and this rank's state after each step."""
    from repro_torch.interop import lm_params_from_reference
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import OptConfig, adamw_init, adamw_update
    from repro_torch.optim.adamw import zero1_dims
    cfg = OptConfig(**kw)
    p = lm_params_from_reference(params, device="cpu")
    state = adamw_init(p, cfg, world)
    steps = []
    for per_rank in grads_by_rank:
        g = lm_params_from_reference(per_rank[world.rank], device="cpu")
        dims = iter(tree_leaves(zero1_dims(p, cfg, world)))

        def cut(x):
            d = next(dims)
            x = x.float()
            if d is None:
                return all_reduce_sum_(x, world).div_(world.size)
            return reduce_scatter_mean(x, d, world)

        g = tree_map(cut, g)
        p, state, met = adamw_update(p, g, state, cfg, world)
        steps.append(dict(params=_tree_to(p, lambda t: t.clone()),
                          state=_tree_to(state, lambda t: t.clone()),
                          grad_norm=float(met["grad_norm"]),
                          lr=float(met["lr"])))
    return {"steps": steps}


def train_steps(world, arch, params, steps, batch, seq, microbatch=0) -> dict:
    """``build_train_step(..., world=)`` of ``arch`` (SMOKE, from the numpy
    params ``params``) over ``steps`` ``synthetic_batch`` steps; the losses,
    the whole params and this rank's state after them."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.interop import lm_params_from_reference
    from repro_torch.launch.train import opt_config_for
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    opt = opt_config_for(cfg, 1)
    p = lm_params_from_reference(params, device="cpu")
    state = adamw_init(p, opt, world)
    step = build_train_step(model, opt, microbatch=microbatch, world=world)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    losses = []
    for i in range(steps):
        b = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(dcfg, i).items()}
        p, state, met = step(p, state, b)
        losses.append(float(met["loss"]))
    return dict(losses=losses, params=p, state=state)


def zero1_suite(world, runs) -> list:
    """:func:`zero1_steps` of every ``(params, grads_by_rank, kw)`` in
    ``runs``."""
    return [zero1_steps(world, *run) for run in runs]


# -- the model axis -------------------------------------------------------------
AXIS_ARCHS = ("granite-20b", "deepseek-coder-33b", "nemotron-4-340b",
              "h2o-danube-1.8b", "paligemma-3b", "seamless-m4t-medium")
# the MoE, SSM and hybrid families; an arch with a suffix of VARIANTS
# runs under its overrides
MOE_SSM_ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b", "mamba2-2.7b",
                 "zamba2-7b")
VARIANTS = {"+dispatch": dict(opt_moe_dispatch=True),
            "+fsdp": dict(fsdp=True),
            # query heads a model axis does not divide (head_dim kept even)
            "+h6": dict(n_heads=6, head_dim=16),
            "+h8": dict(n_heads=8, head_dim=16),
            "+h6kv6": dict(n_heads=6, n_kv_heads=6, head_dim=16, d_ff=126),
            # two SSM heads of 64 channels: 1/1/0 over a model axis of 3
            "+ssm2": dict(ssm_headdim=64)}
ENC_LEN = 16


def axis_config(arch, **overrides):
    """``arch``'s SMOKE config (fp32) with its FULL config's ``fsdp`` and
    ``remat``: sequence parallelism and FSDP where the FULL config has
    them, each layer recomputed in the backward.  ``arch`` with a suffix
    of :data:`VARIANTS`: under its overrides too (``+dispatch``:
    ``opt_moe_dispatch``; ``+fsdp``: FSDP and sequence parallelism)."""
    from repro_torch.configs import get_config
    arch, plus, variant = arch.partition("+")
    kw = dict(fsdp=get_config(arch).fsdp, remat=get_config(arch).remat)
    kw.update(VARIANTS[plus + variant] if plus else {}, **overrides)
    return get_config(arch, smoke=True, **kw)


def axis_batch(cfg, step, batch, seq) -> dict:
    """numpy inputs of step ``step``: ``synthetic_batch``'s tokens and
    labels, and the vision prefix's patch embeddings or the enc-dec's
    frames drawn from the step."""
    from repro_torch.data import DataConfig, synthetic_batch
    out = dict(synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                          global_batch=batch), step))
    rng = np.random.default_rng(100 + step)
    if cfg.frontend == "vision":
        out["frontend"] = rng.standard_normal(
            (batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        out["enc_frames"] = rng.standard_normal(
            (batch, ENC_LEN, cfg.d_model)).astype(np.float32)
    return out


def as_torch(batch) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


COLLECTIVES = ("copy_to", "reduce_from", "gather_from", "scatter_to",
               "split_to")


def axis_collectives(world) -> dict:
    """Each differentiable collective over each axis of more than one
    rank, on seeded per-rank inputs: the forward and the gradient of the
    input under a seeded per-rank output gradient; and
    ``all_reduce_max_``."""
    from repro_torch.distributed import comm
    out = {}
    for name in ("data", "model"):
        axis = getattr(world, name)
        if axis.size == 1:
            continue
        out[name] = {"ranks": axis.ranks, "index": axis.rank}
        for op in COLLECTIVES:
            x = ranked(world, (2, 2 * axis.size, 3)).requires_grad_(True)
            fn = getattr(comm, op)
            y = fn(x, axis) if op in ("copy_to", "reduce_from") \
                else fn(x, 1, axis)
            g = torch.Generator().manual_seed(2000 + world.rank)
            gy = torch.randn(y.shape, generator=g)
            y.backward(gy)
            out[name][op] = (y.detach(), x.grad)
        out[name]["max"] = comm.all_reduce_max_(
            ranked(world, (5,)), axis)
    return out


def _gathered_state(model, params, state, opt, world):
    from repro_torch.models.common import gather_cuts, tree_leaves
    if world is None:
        return state
    from repro_torch.optim import state_cuts
    cuts = state_cuts(params, opt, world, model.places(params))
    it = iter(tree_leaves(cuts))
    return _tree_to(state, lambda t: gather_cuts(t, next(it), world))


def axis_layout(model, params, opt, world) -> dict:
    """The ``dims`` of a params-and-state checkpoint over ``world``."""
    from repro_torch.models.common import tree_map_paths
    from repro_torch.optim import state_cuts
    places = model.places(params)
    return {"params": tree_map_paths(lambda _, pl: pl.cuts, places),
            "opt": state_cuts(params, opt, world, places)}


def _first_grads(opt, world, model, params):
    """A context that keeps the gradients the train step hands
    ``adamw_update`` at its first call (this rank's ZeRO-1 slices of its
    model cuts), gathered whole (a one-element list, filled)."""
    import contextlib

    from repro_torch.models.common import gather_cuts, tree_leaves
    from repro_torch.optim import state_cuts
    from repro_torch.train import steps as steps_mod
    seen = []

    @contextlib.contextmanager
    def spying():
        real = steps_mod.adamw_update

        def spy(p, g, *args, **kw):
            if not seen:
                if world is None:
                    seen.append(_tree_to(g, lambda t: t.clone()))
                else:
                    cuts = iter(tree_leaves(state_cuts(
                        p, opt, world, model.places(p))["m"]))
                    seen.append(_tree_to(g, lambda t: gather_cuts(
                        t, next(cuts), world)))
            return real(p, g, *args, **kw)
        steps_mod.adamw_update = spy
        try:
            yield seen
        finally:
            steps_mod.adamw_update = real
    return spying()


def axis_train(world, arch, steps, batch, seq, opt_kw=None,
               ckpt=None, microbatch=0, card=False, grads=False) -> dict:
    """``steps`` steps of ``build_train_step`` over ``world`` (None: one
    device, ``microbatch``) from the seeded init, on the CPU or, with
    ``card``, on this rank's card: the losses, the whole params and state
    after them (on the host), with ``grads`` the first step's gradients
    as the optimizer takes them, gathered whole, and, with ``ckpt``, a
    save there."""
    import contextlib

    from repro_torch.ckpt import save_checkpoint
    from repro_torch.launch.train import opt_config_for
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import build_train_step
    dev = torch.device("cpu") if not card else (
        torch.device("cuda") if world is None else world.device)
    cfg = axis_config(arch)
    model = build_model(cfg, world)
    p = model.init(0, device=dev)
    opt = OptConfig(**opt_kw) if opt_kw else opt_config_for(cfg, steps)
    state = adamw_init(p, opt, world, model.places(p))
    step = build_train_step(model, opt, microbatch=microbatch)
    losses = []
    spy = (_first_grads(opt, world, model, p) if grads
           else contextlib.nullcontext([]))
    with spy as seen:
        for i in range(steps):
            b = {k: v.to(dev) for k, v in
                 as_torch(axis_batch(cfg, i, batch, seq)).items()}
            p, state, met = step(p, state, b)
            losses.append(float(met["loss"]))
    if ckpt:
        save_checkpoint(ckpt, steps, {"params": p, "opt": state},
                        world=world, dims=None if world is None else
                        axis_layout(model, p, opt, world))
    host = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t  # noqa
    out = dict(losses=losses, params=_tree_to(model.gather(p), host),
               state=_tree_to(_gathered_state(model, p, state, opt, world),
                              host))
    if grads:
        out["grads"] = _tree_to(seen[0], host)
    return out


def axis_restore(world, arch, ckpt, steps, opt_kw=None) -> dict:
    """Restore ``ckpt`` into this world's slices (a fresh init of another
    seed as the tree) and gather it whole again."""
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.launch.train import opt_config_for
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig, adamw_init
    cfg = axis_config(arch)
    model = build_model(cfg, world)
    p = model.init(1, device="cpu")
    opt = OptConfig(**opt_kw) if opt_kw else opt_config_for(cfg, steps)
    like = {"params": p, "opt": adamw_init(p, opt, world, model.places(p))}
    tree, at = restore_checkpoint(ckpt, like, device="cpu", world=world,
                                  dims=axis_layout(model, p, opt, world))
    return dict(step=at, params=model.gather(tree["params"]),
                state=_gathered_state(model, tree["params"], tree["opt"],
                                      opt, world))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _routes_of(fn):
    """``fn()`` and the ``assign`` of every route the MoE layers took in
    it, in order."""
    from repro_torch.models import moe as moe_mod
    routes, real = [], (moe_mod.route_matching, moe_mod.route_topk)

    def keep(route):
        def wrapped(*args, **kw):
            out = route(*args, **kw)
            routes.append(out[0].clone())
            return out
        return wrapped
    moe_mod.route_matching, moe_mod.route_topk = (keep(r) for r in real)
    try:
        return fn(), routes
    finally:
        moe_mod.route_matching, moe_mod.route_topk = real


def axis_serve(world, arch, batch, seq, decode_steps) -> dict:
    """The forward's logits (with the routes its MoE layers took), the
    ``attn_impl="pallas"`` prefill and ``decode_steps`` teacher-forced
    serve steps, all gathered whole, the KV cache's heads and the SSM
    state's heads on this rank, and whether ``Model.shard`` of the
    one-device init is this rank's init, leaf for leaf."""
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.train import build_prefill_step, build_serve_step
    cfg = axis_config(arch)
    model = build_model(cfg, world)
    p = model.init(0, device="cpu")
    cut = model.shard(build_model(cfg).init(0, device="cpu"))
    same = all(torch.equal(x, y) and x.shape == y.shape for x, y in zip(
        _leaves(p), _leaves(cut)))
    b = as_torch(axis_batch(cfg, 7, batch, seq))
    logits, routes = _routes_of(
        lambda: model.gather_logits(model.forward(p, b)[0]))
    pallas = build_model(dataclasses.replace(cfg, attn_impl="pallas"), world)
    prefill = build_prefill_step(pallas)(p, b)
    cache = model.init_cache(batch, decode_steps, enc_len=ENC_LEN,
                             device="cpu")
    if cfg.enc_layers:
        cache = model.prefill_encoder(p, cache, b)
    serve = build_serve_step(model)
    dec = []
    for t in range(decode_steps):
        lg, cache = serve(p, cache, b["tokens"][:, t:t + 1])
        dec.append(lg)
    kv = cache.get("shared_kv", cache)
    return dict(logits=logits, prefill=prefill, decode=torch.cat(dec, 1),
                kv_heads=int(kv["k"].shape[3]) if "k" in kv else None,
                ssm=(tuple(cache["h"].shape), tuple(cache["conv"].shape))
                if "h" in cache else None, routes=routes,
                shard_is_init=same)


def axis_mamba(world, arch, batch, seq) -> dict:
    """The first mamba block's mixer (``mamba_forward``) of ``arch``'s
    seeded init on this rank's SSM heads and their ``d_inner`` channels,
    cut here in blocks of ``ceil(Hs / M)`` heads, not by ``leaf_place``:
    its output (this rank's part of the sum) and its final state."""
    from repro_torch.models import build_model, ssm
    from repro_torch.models.common import axis_range, model_block, tree_map
    cfg = axis_config(arch)
    Hs, m = cfg.ssm_heads, world.model.size
    lo, hi = axis_range(Hs, model_block(Hs, m), world.model.rank)
    hd = cfg.ssm_headdim
    heads, chans = slice(lo, hi), slice(lo * hd, hi * hd)
    whole = tree_map(lambda t: t[0], build_model(cfg).init(
        0, device="cpu")["layers"]["mix"])
    cut = {"wz": (1, chans), "wx": (1, chans), "conv_x": (1, chans),
           "wdt": (1, heads), "A_log": (0, heads), "Dp": (0, heads),
           "dt_bias": (0, heads), "norm": (0, chans), "out": (0, chans)}
    mine = {k: (t if k not in cut else t.narrow(
        cut[k][0], cut[k][1].start, cut[k][1].stop - cut[k][1].start))
        for k, t in whole.items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (batch, seq, cfg.d_model)).astype(np.float32))
    y, h = ssm.mamba_forward(mine, x, cfg, axis=world.model)
    return dict(y=y, h=h)


def dry_step_costs(world, arch, kind, batch, seq) -> dict:
    """One ``kind`` step ("train", "prefill" or "decode") of ``arch``'s
    SMOKE config (its FULL config's ``fsdp`` and ``remat``) over
    ``world`` (None: one device) on the CPU, as the dry run builds it,
    from the seeded init: its costs under ``hlo_cost.analyze`` (the
    collectives' calls and bytes by axis and op among them)."""
    from repro_torch.configs.shapes import ShapeCell, make_inputs
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_cost import analyze
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import (batch_rows, build_prefill_step,
                                   build_serve_step, build_train_step)
    cfg = axis_config(arch)
    shape = ShapeCell(kind, seq, batch, kind)
    model = build_model(cfg, world)
    p = model.init(0, device="cpu")
    inputs = make_inputs(cfg, shape, seed=1, device="cpu")
    if kind == "train":
        opt = dryrun.opt_config_for(cfg)
        state = adamw_init(p, opt, world,
                           None if world is None else model.places(p))
        cost = analyze(build_train_step(model, opt), p, state, inputs)
    elif kind == "prefill":
        cost = analyze(build_prefill_step(model), p,
                       batch_rows(inputs, world))
    else:
        enc_len = max(cfg.frontend_len, 1024) if cfg.enc_layers else 0
        cache = model.init_cache(
            batch // (1 if world is None else world.data.size), seq,
            enc_len=enc_len, device="cpu")
        cache["pos"] = seq - 1
        cost = analyze(build_serve_step(model), p, cache,
                       batch_rows(inputs, world)["tokens"])
    cost.pop("result")
    return cost


def axis_remesh(world, mesh) -> dict:
    """The world remeshed to ``mesh``: its axes, and a sum over each."""
    from repro_torch.distributed import all_reduce_sum_, current_world
    w = world.remesh(mesh)
    out = {"current": current_world() is w, "ident": w.ident != world.ident}
    for name in ("data", "model"):
        ax = getattr(w, name)
        out[name] = (ax.rank, ax.size, ax.ranks, float(all_reduce_sum_(
            torch.tensor([float(w.rank)]), ax)))
    return out


def axis_jobs(world, jobs) -> dict:
    """Every job ``(key, function name, args)`` in turn."""
    return {key: globals()[fn](world, *args) for key, fn, args in jobs}


def axis_suite(world, jobs) -> dict:
    """:func:`axis_jobs`, and the collectives."""
    out = axis_jobs(world, jobs)
    out["collectives"] = axis_collectives(world)
    return out


def _collective_want(op, xs, gys, me, dim=1):
    """(forward, input gradient) of ``op`` on rank ``me`` of an axis whose
    ranks hold ``xs`` and feed back ``gys``."""
    n = len(xs)

    def piece(t, i):
        k = t.shape[dim] // n
        return t.narrow(dim, i * k, k)

    if op == "copy_to":
        return xs[me], sum(gys)
    if op == "reduce_from":
        return sum(xs), gys[me]
    if op == "gather_from":
        return torch.cat(xs, dim), piece(sum(gys), me)
    if op == "scatter_to":
        return piece(sum(xs), me), torch.cat(gys, dim)
    return piece(xs[me], me), torch.cat(gys, dim)          # split_to


def check_collectives(results, name, op):
    """Every rank's ``op`` over axis ``name`` against its one-process
    value (the ranks' inputs and output gradients drawn again here, as
    ``torch_world_ranks.axis_collectives`` draws them)."""
    for r in results:
        c = r["collectives"][name]
        stand = [type("Rank", (), {"rank": g})() for g in c["ranks"]]
        if op == "max":
            xs = [ranked(w, (5,)) for w in stand]
            assert torch.equal(c["max"], torch.stack(xs).amax(0))
            continue
        got_fwd, got_grad = c[op]
        xs = [ranked(w, (2, 2 * len(stand), 3)) for w in stand]
        gys = [torch.randn(got_fwd.shape, generator=torch.Generator()
                           .manual_seed(2000 + w.rank)) for w in stand]
        fwd, grad = _collective_want(op, xs, gys, c["index"])
        torch.testing.assert_close(got_fwd, fwd, rtol=0, atol=1e-6)
        torch.testing.assert_close(got_grad, grad, rtol=0, atol=1e-6)


def axis_card_prefill(world, arch, batch, seq) -> dict:
    """The ``attn_impl="pallas"`` prefill of ``arch`` (SMOKE, fp32) on this
    rank's card over the world's model axis: the gathered logits and K4's
    launches on this rank (its counts set to 0 just before)."""
    import dataclasses
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.train import build_prefill_step
    cfg = dataclasses.replace(axis_config(arch), attn_impl="pallas")
    model = build_model(cfg, world)
    p = model.init(0)
    dev = "cuda" if world is None else world.device
    b = {k: v.to(dev)
         for k, v in as_torch(axis_batch(cfg, 7, batch, seq)).items()}
    fa.reset_launches()
    logits = build_prefill_step(model)(p, b)
    torch.cuda.synchronize()
    return dict(logits=logits.cpu(), launches=dict(fa.LAUNCHES))


# -- the service's oversize lane over a world ------------------------------------
LANE_BUCKET = (256, 256, 2048)


def _lane_service(world, faults=None, **kw):
    from repro_torch.matching import MatcherConfig, make_mesh
    from repro_torch.serving import Bucketizer, MatchingService, SizeBucket
    return MatchingService(
        bucketizer=Bucketizer((SizeBucket(*LANE_BUCKET),), oversize="shard",
                              validate=True, device=world.device),
        config=MatcherConfig(), warm_start="cheap", max_batch=4,
        mesh=make_mesh((world.size,), ("data",)), faults=faults,
        supervisor_interval_s=0.02, **kw)


def _result(fut) -> dict:
    """A resolved request: its route, variant and state, or its error."""
    exc = fut.exception(timeout=120)
    if exc is not None:
        return dict(error=type(exc).__name__, message=str(exc))
    res = fut.result()
    return dict(route=res.route, variant=res.stats.variant,
                bucket=res.bucket, state=outcome(res.state))


def _lane_config(path: str):
    from repro_torch.matching import SOLVE_PATHS, MatcherConfig
    return SOLVE_PATHS[path].configure(MatcherConfig())


LANE_REFUSED = ("legacy", "none")   # the pair a follower cannot take


def _refusing_followers(world):
    """``serve_followers`` on a rank whose matchers refuse the
    ``LANE_REFUSED`` (solve path, warm start) pair."""
    from repro_torch.matching import Matcher
    from repro_torch.serving import serve_followers, world_lane
    real = world_lane.ShardedMatcher
    path, ws = LANE_REFUSED
    refused = (Matcher(_lane_config(path), ws).config, ws)  # as sent

    def refusing(mesh, axis, config, warm_start):
        if (config, warm_start) == refused:
            raise RuntimeError("this rank refuses the request")
        return real(mesh, axis, config, warm_start)

    world_lane.ShardedMatcher = refusing
    try:
        return serve_followers(world)
    finally:
        world_lane.ShardedMatcher = real


def _keep_busy(svc, small, seconds: float, pending: int = 12) -> list:
    """Keep ``pending`` in-bucket requests (the ``small`` graphs) queued
    on ``svc`` for ``seconds``, so that a batch is ready on every pass of
    its flush thread; the routes of all of them."""
    futs, done, end = [], [], time.monotonic() + seconds
    while time.monotonic() < end:
        done += [f for f in futs if f.done()]
        futs = [f for f in futs if not f.done()]
        while len(futs) < pending:
            futs.append(svc.submit(small[len(futs) % len(small)]))
        time.sleep(0.001)
    return [f.result(timeout=120).route for f in done + futs]


def lane_suite(world, big, small, runs, store, idle_timeout):
    """``test_torch_serving_world``'s rank: rank 0 serves, the others
    follow.  (1) ``big`` under each (solve path, warm start) of ``runs``,
    the ``small`` graphs (in-bucket), the poisoned request, a flush thread
    killed before a sharded dispatch, one more ``big``, a request the
    followers refuse (``LANE_REFUSED``); (2) a service without a
    supervisor whose flush thread dies, closed; (3) in a world re-made with
    ``idle_timeout`` (the store at ``store``), an idle lane past that
    timeout, then ``big``; then in-bucket traffic alone, a batch always
    ready, for longer than the timeout, then ``big``."""
    from repro_torch.distributed import close_world, init_world
    from repro_torch.serving import FaultInjector, serve_followers
    out = {"rank": world.rank}
    faults = FaultInjector(seed=0)
    if world.rank:
        out["suite"] = _refusing_followers(world)
        out["dead"] = serve_followers(world)
    else:
        svc = _lane_service(world, faults)
        got = {}
        for path, ws in runs:
            got[(path, ws)] = _result(svc.submit(
                big, config=_lane_config(path), warm_start=ws))
        before = dict(svc.lane.sent)
        futs = [svc.submit(g) for g in small]
        svc.drain()
        got["small"] = [_result(f) for f in futs]
        out["sent_around_small"] = (before, dict(svc.lane.sent))
        faults.poison("bad")
        got["poisoned"] = _result(svc.submit(big, tag="bad"))
        faults.cure("bad")
        faults.kill_thread_after(0)
        got["killed"] = _result(svc.submit(big))
        got["after"] = _result(svc.submit(big))
        got["follower-bad"] = _result(svc.submit(
            big, config=_lane_config(LANE_REFUSED[0]),
            warm_start=LANE_REFUSED[1], tag="follower-bad"))
        svc.close()
        out.update(suite=got, snap=svc.metrics.snapshot(),
                   sent=dict(svc.lane.sent))
        # the flush thread dies, nothing restarts it: close() stops the lane
        faults.kill_thread_after(0)
        dead = _lane_service(world, faults, supervise=False)
        fut = dead.submit(big)
        dead._thread.join(timeout=60)
        dead.close()
        out["dead"] = dict(result=_result(fut), sent=dict(dead.lane.sent))
    rank, size = world.rank, world.size
    close_world()
    world = init_world(rank, size, "file://" + store, device="cpu",
                       timeout=idle_timeout)
    if rank:
        out["idle"] = serve_followers(world)
    else:
        svc = _lane_service(world)
        time.sleep(2.5 * idle_timeout)
        out["idle"] = dict(result=_result(svc.submit(big)),
                           timeout=world.timeout, idle_s=svc.lane.idle_s,
                           sent=dict(svc.lane.sent))
        routes = _keep_busy(svc, small, 1.5 * idle_timeout)
        out["busy"] = dict(routes=routes, sent=dict(svc.lane.sent),
                           result=_result(svc.submit(big)))
        svc.close()
        out["busy"]["closed"] = dict(svc.lane.sent)
    return out


def lane_runs(world, big, runs):
    """``big`` through the lane once per (solve path, warm start) of
    ``runs``: rank 0's results, the others' runs, and on a card each
    rank's kernel launches over them."""
    from repro_torch.serving import serve_followers
    card = world.device.type == "cuda"
    if card:
        from repro_torch.kernels.frontier_expand import (LAUNCHES,
                                                         reset_launches)
        reset_launches()
    if world.rank:
        got = serve_followers(world)
    else:
        svc = _lane_service(world)
        got = [_result(svc.submit(big, config=_lane_config(path),
                                  warm_start=ws)) for path, ws in runs]
        svc.close()
    return dict(got=got, launches=dict(LAUNCHES) if card else None)
