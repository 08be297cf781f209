"""Step builders (the JAX package's ``train/steps.py``): the train step
with its loss, ``cross_entropy``, and the serving path's prefill and serve
steps.  PyTorch runs eagerly, so ``build_*`` returns the plain function
where the JAX one returns the function that is then jitted; the mesh and
sharding helpers (``named``, ``batch_sharding``) are not ported (ROADMAP.md,
Queue 1, item 13)."""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.models import Model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import OptConfig, adamw_update


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    return lse - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  chunk: int = 512) -> torch.Tensor:
    """Mean token cross-entropy; the fp32 logsumexp in sequence chunks of
    ``chunk`` positions (then the remainder), summed in the JAX function's
    order, so the (B, S, V) fp32 upcast is never made whole."""
    B, S, V = logits.shape
    if S <= chunk:
        return _token_nll(logits, labels).mean()
    n = S // chunk
    tot = torch.zeros((), dtype=torch.float32, device=logits.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        tot = tot + _token_nll(logits[:, sl], labels[:, sl]).sum()
    if S - n * chunk:
        tot = tot + _token_nll(logits[:, n * chunk:],
                               labels[:, n * chunk:]).sum()
    return tot / (B * S)


def build_train_step(model: Model, opt_cfg: OptConfig, microbatch: int = 0):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` with metrics ``loss``, ``grad_norm`` and ``lr``
    (0-d tensors).  Gradients come from ``torch.autograd`` over
    ``Model.forward``; the params are ``requires_grad`` leaves only inside
    the step.  ``microbatch > 1`` splits the batch's rows into that many
    sequential chunks (chunk i holds rows ``[i*B/mb, (i+1)*B/mb)``), sums
    their fp32 grads, divides by ``microbatch`` and takes the mean of the
    losses.  The params and state are updated in place (``adamw_update``)
    and returned."""
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        loss = cross_entropy(logits, batch["labels"])
        if cfg.family == "moe":
            loss = loss + 0.01 * aux["lb_loss"] / max(1, cfg.n_layers)
        return loss

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        with torch.enable_grad():
            loss = loss_fn(tree_map(lambda _: next(it), params), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if microbatch > 1:
            B = next(iter(batch.values())).shape[0]
            if B % microbatch:
                raise ValueError(f"batch of {B} rows does not split into "
                                 f"{microbatch} microbatches")
            rows = B // microbatch
            gsum: List[torch.Tensor] = []
            losses = []
            for i in range(microbatch):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                loss, g = grads_of(params, mb)
                if not gsum:
                    gsum = [torch.zeros(x.shape, dtype=torch.float32,
                                        device=x.device) for x in g]
                for acc, x in zip(gsum, g):
                    acc.add_(x)
                del g
                losses.append(loss)
            grads = [acc / microbatch for acc in gsum]
            del gsum
            loss = torch.stack(losses).mean()
        else:
            loss, grads = grads_of(params, batch)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def build_prefill_step(model: Model):
    """Serving prefill: full forward, next-token logits only (the MoE
    family's ``aux`` is dropped here, as in the JAX package).  ``batch``
    carries what the model's forward takes: ``tokens``, and the vision
    prefix's ``frontend`` or the enc-dec's ``enc_frames``."""
    def prefill(params, batch):
        logits, _ = model.forward(params, batch, last_only=True)
        return logits

    return prefill


def build_serve_step(model: Model):
    """One decode step: (params, cache, tokens) -> (logits, cache)."""
    def serve(params, cache, tokens):
        return model.decode_step(params, cache, tokens, cache["pos"])

    return serve
