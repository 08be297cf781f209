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
