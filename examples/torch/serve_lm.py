"""Batched serving on the PyTorch port: prefill a batch of prompts, decode
with the KV/SSM cache.

    PYTHONPATH=src python examples/torch/serve_lm.py [--arch mamba2-2.7b]
    PYTHONPATH=src python examples/torch/serve_lm.py --device cpu
"""
import argparse

from repro_torch.configs import ARCH_NAMES
from repro_torch.launch.serve import run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-2.7b", choices=ARCH_NAMES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run(args.arch, smoke=True, batch=args.batch,
              prompt_len=args.prompt_len, gen=args.gen, device=args.device)
    print("generated token ids (first sequence):", out[0].tolist())


if __name__ == "__main__":
    main()
