"""Fault-tolerant training launcher (the JAX package's ``launch/train.py``).

``python -m repro_torch.launch.train --arch <id> [--smoke] --steps N
[--batch B] [--seq S] [--ckpt-dir DIR] [--microbatch K] [--lr LR]
[--simulate-failure K] [--mesh D | DxM] [--device cpu]``

The loop is restart-safe: the state lives in step-atomic checkpoints
(:mod:`repro_torch.ckpt`, the JAX package's layout); on start it resumes
from the newest manifest; the data pipeline is a pure function of (seed,
step), so no data state is saved.  ``--simulate-failure K`` saves at step
K and ends the process at once with exit code 17, so a restart must
continue bit for bit.  It runs on the card unless ``--device`` names
another device.

``--mesh D`` (or ``Dx1``) trains data-parallel over a world of ``D`` ranks
(:mod:`repro_torch.distributed`): started here through ``run_world``, or,
under ``torchrun`` (its environment set), this process is one rank of
torchrun's world.  Each rank steps its rows of the global batch, the
optimizer state is cut by ZeRO-1, checkpoints are written whole by rank 0
(so any world size, or one device, resumes them), and rank 0 alone prints.
``--simulate-failure K`` then saves collectively and every rank, and this
process, exits 17.  The backend follows where the ranks sit: NCCL when
each has a card of its own, else gloo.
``--mesh DxM`` adds the model axis: a world of ``D x M`` ranks (rank
``r`` at data index ``r // M``, model index ``r % M``), each rank holding
its slices of the model (:mod:`repro_torch.models.common`'s placement:
tensor parallelism over heads, ``d_ff`` and the vocab in blocks of
``ceil(n / M)``, K/V heads that ``M`` does not divide replicated, the MoE
family's experts, the SSM's ``d_inner`` and heads, sequence parallelism and
FSDP where the config has ``fsdp``); the step is the one-device
``microbatch=D`` step.  It takes all ten architectures at any ``M``,
experts and SSM heads in blocks of ``ceil(n / M)`` too (``--mesh 1x3``
trains granite-20b SMOKE, whose 4 heads go 2/2/0, and mamba2-2.7b SMOKE,
whose 8 SSM heads go 3/3/2).  On the CPU: ``--mesh 2x2 --device cpu``
(gloo); on the cards, NCCL where each rank has a card of its own, gloo
where they share one.

Each logged step prints ``loss`` to four places, as the JAX launcher does,
and the float in full after ``exact``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.distributed import close_world, init_world, run_world
from repro_torch.models import build_model
from repro_torch.models.common import tree_map_paths
from repro_torch.optim import OptConfig, adamw_init, state_cuts
from repro_torch.train import build_train_step


def opt_config_for(cfg, steps: int, lr: float = 3e-4) -> OptConfig:
    """The JAX launcher's choice: the factored state above 60e9 parameters
    (fp32 master copies below), a warm-up of a tenth of the run, at most
    100 steps."""
    big = cfg.params_count() > 60e9
    return OptConfig(lr=lr, factored=big, master_fp32=not big,
                     warmup=min(100, steps // 10 + 1))


def parse_mesh(mesh: str) -> tuple:
    """``(D, M)`` of ``--mesh``: ``D`` or ``DxM``."""
    parts = [int(x) for x in mesh.lower().split("x")]
    if len(parts) > 2 or min(parts) < 1:
        raise ValueError(f"--mesh {mesh}: give D or DxM")
    return (parts[0], parts[1] if len(parts) == 2 else 1)


def _torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def run(arch: str, steps: int, smoke: bool, batch: int, seq: int,
        ckpt_dir: str, simulate_failure: int = 0, microbatch: int = 0,
        log_every: int = 10, lr: float = 3e-4, device=None, mesh: str = "1"):
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``);
    returns (params, opt_state, [(step, loss), ...] as logged).  Over a
    world of ranks started here (``mesh`` D > 1, or DxM) the params and
    state stay in the ranks: returns (None, None, rank 0's logged
    losses)."""
    shape = parse_mesh(mesh)
    ranks = shape[0] * shape[1]
    args = (arch, steps, smoke, batch, seq, ckpt_dir, simulate_failure,
            microbatch, log_every, lr)
    if _torchrun():
        world = init_world(device=device, mesh=shape)
        try:
            return train(world, *args)
        finally:
            close_world()
    if ranks == 1:
        return train(None, *args, device=device)
    losses = run_world(_rank, ranks, *args, device=device, timeout=3600,
                       mesh=shape)[0]
    return None, None, losses


def _rank(world, *args):
    """One rank started by ``run``: its logged losses (rank 0's print)."""
    return train(world, *args)[2]


def train(world, arch: str, steps: int, smoke: bool, batch: int, seq: int,
          ckpt_dir: str, simulate_failure: int = 0, microbatch: int = 0,
          log_every: int = 10, lr: float = 3e-4, device=None):
    """The training loop on one device (``world`` None) or as one rank of
    ``world``; returns (params, this rank's state, logged losses)."""
    dev = resolve_device(device) if world is None else world.device
    talk = world is None or world.rank == 0
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg, world)
    params = model.init(0, device=dev)
    opt_cfg = opt_config_for(cfg, steps, lr)
    places = None if world is None else model.places(params)
    opt_state = adamw_init(params, opt_cfg, world, places)
    dims = None if world is None else {
        "params": tree_map_paths(lambda _, pl: pl.cuts, places),
        "opt": state_cuts(params, opt_cfg, world, places)}

    def save(step):
        save_checkpoint(ckpt_dir, step, {"params": params, "opt": opt_state},
                        world=world, dims=dims)

    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        state, start = restore_checkpoint(
            ckpt_dir, {"params": params, "opt": opt_state}, device=dev,
            world=world, dims=dims)
        params, opt_state = state["params"], state["opt"]
        if talk:
            print(f"[train] resumed from step {start}", flush=True)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    step_fn = build_train_step(model, opt_cfg, microbatch=microbatch,
                               world=world)
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        batch_t = {k: torch.from_numpy(v).to(dev)
                   for k, v in synthetic_batch(dcfg, step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch_t)
        if simulate_failure and step + 1 == simulate_failure:
            # checkpoint then die hard: the restart path must resume
            save(step + 1)
            if talk:
                print(f"[train] simulated failure at step {step + 1}",
                      flush=True)
            if world is not None:
                sys.exit(17)            # every rank; run_world passes it on
            os._exit(17)
        if (step + 1) % log_every == 0 or step + 1 == steps:
            loss = float(metrics["loss"])       # waits for the step
            losses.append((step + 1, loss))
            dt = time.time() - t0
            if talk:
                print(f"[train] step {step + 1:5d} loss {loss:.4f} "
                      f"({dt / max(1, step + 1 - start):.2f}s/step) "
                      f"exact {loss!r}", flush=True)
        if ckpt_dir and ((step + 1) % 50 == 0 or step + 1 == steps):
            save(step + 1)
    return params, opt_state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="1")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--simulate-failure", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args()
    try:
        parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    run(args.arch, args.steps, args.smoke, args.batch, args.seq,
        args.ckpt_dir, args.simulate_failure, args.microbatch, lr=args.lr,
        device=args.device, mesh=args.mesh)


if __name__ == "__main__":
    main()
