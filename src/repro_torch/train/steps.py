"""Step builders (the JAX package's ``train/steps.py``): the train step
with its loss, ``cross_entropy``, and the serving path's prefill and serve
steps.  PyTorch runs eagerly, so ``build_*`` returns the plain function
where the JAX one returns the function that is then jitted.

Data parallelism over a world's ranks (the reference's ``batch_sharding``
over the data axis): :func:`batch_rows` gives rank ``r`` rows ``[r B/W,
(r+1) B/W)`` of the global batch, and ``build_train_step(..., world=)``
runs the step body on them, then reduce-scatters the fp32 gradients with
the mean (ZeRO-1, ``optim.adamw``) and takes the mean of the ranks'
losses.  That is the reference's ``build_train_step(microbatch=W)``: the
mean of ``W`` contiguous blocks' mean losses and gradients (a rank's own
``microbatch`` m makes it ``microbatch=W m``), in every family, the MoE
family's batch-dependent ``lb_loss`` and routing capacity included.

Over a world of ``D x M`` ranks (a model built with
``build_model(cfg, world)``): rows are cut over ``data`` only, the model
ranks of a data group stepping the same rows; the logits are this rank's
vocab columns and :func:`cross_entropy` is vocab-parallel (the max and the
sum of exponentials reduced over ``model``, the gold logit from the rank
that holds it); the gradients of leaves whole on every model rank whose
parts each rank holds (``Place.sum_model``) are summed over ``model``,
FSDP leaves arrive already summed over ``data`` (the backward of their
gather) and are divided by ``D``, every other leaf goes through ZeRO-1
over ``data``.  That step is the one-device ``microbatch=D`` step.
:func:`build_prefill_step` and :func:`build_serve_step` return the whole
vocab's logits (gathered over ``model``)."""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.distributed.comm import (all_reduce_max_, all_reduce_sum_,
                                          reduce_from, reduce_scatter_mean)
from repro_torch.models import Model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.optim.adamw import zero1_dims


def _token_nll(logits: torch.Tensor, labels: torch.Tensor,
               model_axis=None, first: int = 0) -> torch.Tensor:
    lg = logits.float()
    if model_axis is None or model_axis.size == 1:
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
        return lse - gold
    # vocab-parallel: this rank holds columns [first, first + ceil(Vp/M)),
    # those past the vocab -1e30 (the last block's past Vp too)
    m = all_reduce_max_(lg.detach().amax(-1), model_axis)
    sumexp = reduce_from(torch.exp(lg - m[..., None]).sum(-1), model_axis)
    ids = labels.long() - first
    hit = (ids >= 0) & (ids < lg.shape[-1])
    gold = torch.gather(lg, -1, ids.clamp(0, lg.shape[-1] - 1)[..., None]
                        )[..., 0]
    gold = reduce_from(torch.where(hit, gold, gold.new_zeros(())),
                       model_axis)
    return torch.log(sumexp) + m - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  chunk: int = 512, model_axis=None,
                  first: int = 0) -> torch.Tensor:
    """Mean token cross-entropy; the fp32 logsumexp in sequence chunks of
    ``chunk`` positions (then the remainder), summed in the JAX function's
    order, so the (B, S, V) fp32 upcast is never made whole.  With
    ``model_axis``: ``logits`` are this rank's vocab columns from
    ``first`` on, and the max, the sum of exponentials and the gold logit
    are reduced over the axis (every rank returns the same loss)."""
    B, S, V = logits.shape

    def nll(lg, lb):
        return _token_nll(lg, lb, model_axis, first)

    if S <= chunk:
        return nll(logits, labels).mean()
    n = S // chunk
    tot = torch.zeros((), dtype=torch.float32, device=logits.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        tot = tot + nll(logits[:, sl], labels[:, sl]).sum()
    if S - n * chunk:
        tot = tot + nll(logits[:, n * chunk:], labels[:, n * chunk:]).sum()
    return tot / (B * S)


def batch_rows(batch: Dict[str, torch.Tensor], world=None
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global ``batch``: rows ``[r B/D, (r+1)
    B/D)`` of every entry, ``r`` this rank's index on the data axis of
    ``D`` ranks (the whole batch without a world)."""
    if world is None:
        return batch
    data = world.data
    B = next(iter(batch.values())).shape[0]
    if B % data.size:
        raise ValueError(f"a batch of {B} rows does not split over "
                         f"{data.size} ranks")
    k = B // data.size
    return {name: v[data.rank * k:(data.rank + 1) * k]
            for name, v in batch.items()}


def build_train_step(model: Model, opt_cfg: OptConfig, microbatch: int = 0,
                     world=None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` with metrics ``loss``, ``grad_norm`` and ``lr``
    (0-d tensors).  Gradients come from ``torch.autograd`` over
    ``Model.forward``; the params are ``requires_grad`` leaves only inside
    the step.  ``microbatch > 1`` splits the batch's rows into that many
    sequential chunks (chunk i holds rows ``[i*B/mb, (i+1)*B/mb)``), sums
    their fp32 grads, divides by ``microbatch`` and takes the mean of the
    losses.  The params and state are updated in place (``adamw_update``)
    and returned.  With ``world`` (module doc): the global batch in, this
    rank's rows stepped, ``opt_state`` this rank's ZeRO-1 slices
    (``adamw_init(params, opt_cfg, world, places)``), the loss the global
    one.  A model built over a world takes that world (``world`` None or
    the same); over a model axis the model must be built over the
    world."""
    cfg = model.cfg
    if model.world is not None:
        if world is not None and world is not model.world:
            raise ValueError("build_train_step: the model is built over "
                             "another world")
        world = model.world
    elif world is not None and world.model.size > 1:
        raise ValueError("build_train_step: a world with a model axis "
                         "needs a model built over it (build_model(cfg, "
                         "world))")
    par = model.par
    vocab_first = 0
    if par is not None:
        from repro_torch.models.transformer import vocab_block
        vocab_first = vocab_block(cfg, par)[0]

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        loss = cross_entropy(logits, batch["labels"], model_axis=(
            None if par is None else par.model), first=vocab_first)
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
        batch = batch_rows(batch, world)
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
        if world is not None:
            loss, grads = reduce_over(world, loss, grads, params)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, om = adamw_update(
            params, grads, opt_state, opt_cfg, world,
            None if world is None else model.places(params))
        return params, opt_state, {"loss": loss, **om}

    def reduce_over(world, loss, grads, params):
        """The global loss and this rank's share of the mean gradients
        (module doc): a leaf's parts summed over ``model`` where
        ``sum_model``; then an FSDP leaf's slice divided by ``D``, a leaf's
        ZeRO-1 slice (``reduce_scatter_mean``), or where its state is whole
        the whole mean (``all_reduce_sum_`` / D); each leaf's whole
        gradient dropped as soon as it is reduced."""
        data = world.data
        loss = all_reduce_sum_(loss.float().clone(), data) / data.size
        places = model.places(params)
        out = []
        for i, (d, pl) in enumerate(zip(
                tree_leaves(zero1_dims(params, opt_cfg, world, places)),
                tree_leaves(places))):
            g = grads[i].float()
            grads[i] = None
            if pl.sum_model:
                all_reduce_sum_(g, world.model)
            if pl.data is not None:
                out.append(g.div_(data.size))
            elif d is None:
                out.append(all_reduce_sum_(g, data).div_(data.size))
            else:
                out.append(reduce_scatter_mean(g, d, data))
            del g
        return loss, out

    return train_step


def build_prefill_step(model: Model):
    """Serving prefill: full forward, next-token logits only (the MoE
    family's ``aux`` is dropped here, as in the JAX package), whole over
    a model axis.  ``batch``
    carries what the model's forward takes: ``tokens``, and the vision
    prefix's ``frontend`` or the enc-dec's ``enc_frames``."""
    def prefill(params, batch):
        logits, _ = model.forward(params, batch, last_only=True)
        return model.gather_logits(logits)

    return prefill


def build_serve_step(model: Model):
    """One decode step: (params, cache, tokens) -> (logits, cache); the
    logits whole over a model axis."""
    def serve(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens, cache["pos"])
        return model.gather_logits(logits), cache

    return serve
