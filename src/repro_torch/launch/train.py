"""Fault-tolerant training launcher (the JAX package's ``launch/train.py``).

``python -m repro_torch.launch.train --arch <id> [--smoke] --steps N
[--batch B] [--seq S] [--ckpt-dir DIR] [--microbatch K] [--lr LR]
[--simulate-failure K] [--device cpu]``

The loop is restart-safe: the state lives in step-atomic checkpoints
(:mod:`repro_torch.ckpt`, the JAX package's layout); on start it resumes
from the newest manifest; the data pipeline is a pure function of (seed,
step), so no data state is saved.  ``--simulate-failure K`` saves at step
K and ends the process at once with exit code 17, so a restart must
continue bit for bit.  It runs on the card unless ``--device`` names
another device.  ``--mesh`` other than ``1`` waits for training over a
mesh of cards (ROADMAP.md, Queue 1, item 13) and is refused.

Each logged step prints ``loss`` to four places, as the JAX launcher does,
and the float in full after ``exact``.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.models import build_model
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train import build_train_step


def opt_config_for(cfg, steps: int, lr: float = 3e-4) -> OptConfig:
    """The JAX launcher's choice: the factored state above 60e9 parameters
    (fp32 master copies below), a warm-up of a tenth of the run, at most
    100 steps."""
    big = cfg.params_count() > 60e9
    return OptConfig(lr=lr, factored=big, master_fp32=not big,
                     warmup=min(100, steps // 10 + 1))


def run(arch: str, steps: int, smoke: bool, batch: int, seq: int,
        ckpt_dir: str, simulate_failure: int = 0, microbatch: int = 0,
        log_every: int = 10, lr: float = 3e-4, device=None, mesh: str = "1"):
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``);
    returns (params, opt_state, [(step, loss), ...] as logged)."""
    if mesh != "1":
        raise NotImplementedError(
            f"--mesh {mesh}: training over a device mesh waits for "
            f"ROADMAP.md, Queue 1, item 13; this launcher trains on one "
            f"device (--mesh 1)")
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    opt_cfg = opt_config_for(cfg, steps, lr)
    opt_state = adamw_init(params, opt_cfg)

    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        state, start = restore_checkpoint(
            ckpt_dir, {"params": params, "opt": opt_state}, device=dev)
        params, opt_state = state["params"], state["opt"]
        print(f"[train] resumed from step {start}", flush=True)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    step_fn = build_train_step(model, opt_cfg, microbatch=microbatch)
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        batch_t = {k: torch.from_numpy(v).to(dev)
                   for k, v in synthetic_batch(dcfg, step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch_t)
        if simulate_failure and step + 1 == simulate_failure:
            # checkpoint then die hard: the restart path must resume
            save_checkpoint(ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state})
            print(f"[train] simulated failure at step {step + 1}",
                  flush=True)
            os._exit(17)
        if (step + 1) % log_every == 0 or step + 1 == steps:
            loss = float(metrics["loss"])       # waits for the step
            losses.append((step + 1, loss))
            dt = time.time() - t0
            print(f"[train] step {step + 1:5d} loss {loss:.4f} "
                  f"({dt / max(1, step + 1 - start):.2f}s/step) "
                  f"exact {loss!r}", flush=True)
        if ckpt_dir and ((step + 1) % 50 == 0 or step + 1 == steps):
            save_checkpoint(ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state})
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
    run(args.arch, args.steps, args.smoke, args.batch, args.seq,
        args.ckpt_dir, args.simulate_failure, args.microbatch, lr=args.lr,
        device=args.device, mesh=args.mesh)


if __name__ == "__main__":
    main()
