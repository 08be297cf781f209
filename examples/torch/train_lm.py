"""End-to-end training driver on the PyTorch port: a decoder LM trained a
few hundred steps on the deterministic synthetic stream, with
checkpointing.

    PYTHONPATH=src python examples/torch/train_lm.py            # 12.6M, quick
    PYTHONPATH=src python examples/torch/train_lm.py --full     # 100M
    PYTHONPATH=src python examples/torch/train_lm.py --device cpu --steps 4

Uses the same fault-tolerant loop as ``repro_torch.launch.train``: kill it
and re-run, and it resumes from the newest checkpoint in ``--ckpt-dir``.
"""
import argparse
import os
import tempfile

import torch

from repro_torch._device import resolve_device
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.models import build_model
from repro_torch.models.common import tree_size
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.train import build_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="100M params, 200 steps")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.full:
        cfg = get_config("h2o-danube-1.8b", smoke=True, n_layers=12,
                         d_model=640, n_heads=8, n_kv_heads=4, d_ff=1920,
                         vocab=32000, window=256)
        steps = args.steps or 200
        seq, batch = 256, 8
    else:
        cfg = get_config("h2o-danube-1.8b", smoke=True, n_layers=6,
                         d_model=320, n_heads=8, n_kv_heads=4, d_ff=960,
                         vocab=8192, window=128)
        steps = args.steps or 120
        seq, batch = 128, 8

    model = build_model(cfg)
    params = model.init(0, device=device)
    print(f"model: {tree_size(params)/1e6:.1f}M params on {device}")
    opt_cfg = OptConfig(lr=3e-3, warmup=20, weight_decay=0.01)
    opt_state = adamw_init(params, opt_cfg)
    step_fn = build_train_step(model, opt_cfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)

    start = 0
    if latest_step(args.ckpt_dir) is not None:
        state, start = restore_checkpoint(
            args.ckpt_dir, {"params": params, "opt": opt_state},
            device=device)
        params, opt_state = state["params"], state["opt"]
        print(f"resumed from step {start}")

    for step in range(start, steps):
        batch_t = {k: torch.from_numpy(v).to(device)
                   for k, v in synthetic_batch(dcfg, step).items()}
        params, opt_state, m = step_fn(params, opt_state, batch_t)
        if (step + 1) % 10 == 0 or step == start:
            print(f"step {step + 1:4d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}")
        if (step + 1) % 50 == 0 or step + 1 == steps:
            save_checkpoint(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state})
    print("done; checkpoints in", args.ckpt_dir)


if __name__ == "__main__":
    main()
