"""The paper's technique as a framework feature: maximum-cardinality
matching for MoE token->expert assignment, against the standard greedy
router, on the PyTorch port.

    PYTHONPATH=src python examples/torch/moe_matching_router.py      # card
    PYTHONPATH=src python examples/torch/moe_matching_router.py --device cpu
"""
import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCell, make_inputs
from repro_torch.models import build_model
from repro_torch.moe import route_matching, route_topk, router_stats


def router_comparison(device):
    print("=== router comparison under expert contention ===")
    T, E, k = 2048, 16, 4
    C = int(1.0 * T * k / E)
    gen = torch.Generator(device=device).manual_seed(0)
    logits = torch.randn(T, E, generator=gen, device=device) \
        + torch.linspace(2.0, 0.0, E, device=device)[None]  # hot experts
    for name, fn in (("greedy top-k", route_topk),
                     ("matching (paper)", route_matching)):
        assign, slot, p = fn(logits, k, C)
        st = router_stats(assign.cpu().numpy(), k)
        print(f"  {name:18s} dropped {st['drop_rate']*100:5.2f}% of "
              f"{st['demand']} (token,expert) assignments")


def end_to_end_moe(device):
    print("=== dbrx-style MoE forward with both routers ===")
    batch = make_inputs(get_config("dbrx-132b", smoke=True),
                        ShapeCell("t", 64, 2, "train"), device=device)
    for router in ("topk", "matching"):
        cfg = get_config("dbrx-132b", smoke=True, router=router,
                         capacity_factor=0.75)   # tight capacity
        model = build_model(cfg)
        params = model.init(0, device=device)
        with torch.no_grad():
            logits, aux = model.forward(params, batch)
        finite = bool(torch.isfinite(logits.float()).all())
        print(f"  router={router:9s} lb_loss={float(aux['lb_loss']):.4f} "
              f"logits {tuple(logits.shape)} finite={finite}")
        if not finite:
            raise SystemExit(f"router={router}: non-finite logits")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    router_comparison(device)
    end_to_end_moe(device)


if __name__ == "__main__":
    main()
