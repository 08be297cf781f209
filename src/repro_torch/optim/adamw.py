"""AdamW with fp32 master state and global-norm clipping (the JAX
package's ``optim/adamw.py``).

The state is a nested dict of tensors with the JAX package's keys, so a
checkpoint maps leaf for leaf: ``m``, ``v``, ``step`` and, with
``master_fp32``, ``master``; in the ``factored`` branch (an
Adafactor-style row/column second moment and a bf16 first moment) ``m``,
``vr``, ``vc`` and ``step``.  ``step`` is a 0-d int32 tensor.

The JAX module's ZeRO-1 sharding specs are not ported: they partition the
state over a mesh (ROADMAP.md, Queue 1, item 13).

``adamw_update`` updates the params and the state in place and returns
them, as a PyTorch optimizer does (the JAX function returns new trees: at
full width a second copy of params and state does not fit on the card).
Leaves are updated a block of elements at a time (:data:`SLAB` on the
card, so a step's fp32 temporaries stay near a slab's size whatever the
leaf's; :data:`CPU_BLOCK` on the CPU, where they then stay in cache).  A factored
moment reduces over a leaf's last two dims, so its leaves go a slab of
whole matrices at a time: the moments from the slab, then the rest in
blocks of rows.  The values are a whole-leaf update's.
``tools/adamw_blocks.py`` measures each choice against the whole leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map

# elements of a leaf updated at once: on the card a slab bounds the fp32
# temporaries of one update; on the CPU a block keeps them in cache
SLAB = 1 << 27
CPU_BLOCK = 1 << 18


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    master_fp32: bool = True
    factored: bool = False      # Adafactor-style row/col second moment +
                                # bf16 first moment: ~1/6 the optimizer bytes


def _factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adamw_init(params, cfg: OptConfig) -> Dict[str, Any]:
    """The zero state of ``params`` (on their devices)."""
    dev = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.factored:
        def mk_vr(p):   # row second moment (last dim reduced)
            shape = p.shape[:-1] if _factorable(p.shape) else p.shape
            return p.new_zeros(shape, dtype=torch.float32)

        def mk_vc(p):   # col second moment (second-to-last reduced)
            if _factorable(p.shape):
                return p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                   dtype=torch.float32)
            return p.new_zeros((1,), dtype=torch.float32)

        return {"m": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.bfloat16), params),
                "vr": tree_map(mk_vr, params),
                "vc": tree_map(mk_vc, params),
                "step": step}
    state = {"m": tree_map(lambda p: torch.zeros_like(
                 p, dtype=torch.float32), params),
             "v": tree_map(lambda p: torch.zeros_like(
                 p, dtype=torch.float32), params),
             "step": step}
    if cfg.master_fp32:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up of the learning rate from the step before the
    increment, in fp32."""
    warm = torch.clamp((step + 1).to(torch.float32) / max(1, cfg.warmup),
                       max=1.0)
    return cfg.lr * warm


def _sorted_leaves(tree) -> list:
    """Leaves in the JAX package's order (dict keys sorted), so the global
    norm sums the leaves in the same order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def _zip(*trees):
    """Tuples of corresponding leaves of trees with the first one's
    structure."""
    first = trees[0]
    if isinstance(first, dict):
        return [x for k in first for x in _zip(*(t[k] for t in trees))]
    return [trees]


def _block(t: torch.Tensor) -> int:
    return SLAB if t.device.type == "cuda" else CPU_BLOCK


def _blocks(n: int, block: int) -> list:
    return [slice(i, min(n, i + block)) for i in range(0, n, block)]


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.view(-1) if t.is_contiguous() else t.reshape(-1)


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """A leaf's fp32 sum of squares, a block at a time (its fp32 copy is
    never made whole)."""
    flat = _flat(g)
    return sum(flat[sl].float().square().sum()
               for sl in _blocks(flat.numel(), _block(g)))


def _flat_out(t: torch.Tensor) -> torch.Tensor:
    """A flat view of a leaf the update writes."""
    if not t.is_contiguous():
        raise ValueError("adamw_update updates contiguous leaves in place; "
                         "this one is strided")
    return t.view(-1)


def _matrices(shape) -> list:
    """Index tuples of a factorable leaf a slab at a time, along its
    leading dims only (the moments reduce over the last two): as many whole
    matrices as fit in SLAB elements, one if a matrix is larger."""
    n = 1
    for s in shape:
        n *= s
    if n <= SLAB or len(shape) <= 2:
        return [(Ellipsis,)]
    inner = 1
    for s in shape[1:]:
        inner *= s
    if inner > SLAB and len(shape) > 3:
        return [(i,) + rest for i in range(shape[0])
                for rest in _matrices(shape[1:])]
    rows = max(1, SLAB // inner)
    return [(slice(i, i + rows),) for i in range(0, shape[0], rows)]


def _work(work: dict, i: int, like: torch.Tensor) -> torch.Tensor:
    """Workspace ``i``: an fp32 tensor of ``like``'s shape over a flat
    buffer kept in ``work`` and grown as needed."""
    buf = work.get(i)
    if buf is None or buf.numel() < like.numel() or buf.device != like.device:
        buf = work[i] = torch.empty(like.numel(), dtype=torch.float32,
                                    device=like.device)
    return buf[:like.numel()].view(like.shape)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``(params, state, {"grad_norm", "lr"})``
    with ``params`` and ``state`` the trees given, updated.  The JAX
    function's order of operations: the global norm of the fp32 grads,
    ``scale = min(1, clip / max(gnorm, 1e-9))``, the learning rate from
    the step before the increment, the bias corrections from the step
    after."""
    gnorm = torch.sqrt(sum(_square_sum(g) for g in _sorted_leaves(grads)))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = _schedule(cfg, state["step"])
    step = state["step"].add_(1)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    def finish(p, m32, vhat):
        """The parameter's step from the first moment and the second
        moment estimate (both fp32)."""
        u = (m32 / b1c) / (torch.sqrt(vhat / b2c) + cfg.eps)
        w32 = p.float()
        return w32 - lr * (u + cfg.weight_decay * w32)

    if cfg.factored:
        work: dict = {}
        for p, g, m, vr, vc in _zip(params, grads, state["m"], state["vr"],
                                    state["vc"]):
            if _factorable(p.shape):
                _factored_leaf(cfg, scale, finish, p, g, m, vr, vc, work)
                continue
            ins = [_flat(t) for t in (p, g, m, vr)]
            o = [_flat_out(t) for t in (p, m, vr)]
            for sl in _blocks(p.numel(), _block(p)):
                pb, gb, mb, vb = (t[sl] for t in ins)
                gb = gb.float() * scale
                m32 = cfg.b1 * mb.float() + (1 - cfg.b1) * gb
                vr_n = cfg.b2 * vb + (1 - cfg.b2) * (gb.square() + 1e-30)
                o[0][sl] = finish(pb, m32, vr_n)
                o[1][sl] = m32
                o[2][sl] = vr_n
        return params, state, {"grad_norm": gnorm, "lr": lr}

    has_master = "master" in state
    for p, g, m, v, w in _zip(params, grads, state["m"], state["v"],
                              state.get("master", params)):
        ins = [_flat(t) for t in (g, m, v, w)]
        o = [_flat_out(t) for t in ((p, m, v, w) if has_master
                                    else (p, m, v))]
        for sl in _blocks(p.numel(), _block(p)):
            gb, mb, vb, wb = (t[sl] for t in ins)
            gb = gb.float() * scale
            m_n = cfg.b1 * mb + (1 - cfg.b1) * gb
            v_n = cfg.b2 * vb + (1 - cfg.b2) * gb.square()
            w32 = finish(wb, m_n, v_n)
            for out, val in zip(o, (w32, m_n, v_n, w32)):
                out[sl] = val
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _factored_leaf(cfg, scale, finish, p, g, m, vr, vc, work: dict
                   ) -> None:
    """The factored update of a factorable leaf, a slab of whole matrices
    at a time: the row and column moments from the slab's squared
    gradient, then the elementwise rest in blocks of rows.  The slab's two
    fp32 temporaries live in ``work``, reused from slab to slab (on the
    CPU a fresh allocation of that size costs more than the arithmetic)."""
    c = p.shape[-1]
    for at in _matrices(tuple(p.shape)):
        ga = g[at]
        gs = torch.mul(ga.float(), scale, out=_work(work, 0, ga))
        g2 = torch.square(gs, out=_work(work, 1, ga)).add_(1e-30)
        vr_n = cfg.b2 * vr[at] + (1 - cfg.b2) * g2.mean(-1)
        vc_n = cfg.b2 * vc[at] + (1 - cfg.b2) * g2.mean(-2)
        del g2
        vmean = torch.clamp(vr_n.mean(-1)[..., None, None], min=1e-30)
        rows = max(1, _block(p) // c)
        pm, mm = p[at], m[at]
        for rs in _blocks(p.shape[-2], rows):
            gb = gs[..., rs, :]
            m32 = cfg.b1 * mm[..., rs, :].float() + (1 - cfg.b1) * gb
            vhat = vr_n[..., rs, None] * vc_n[..., None, :] / vmean
            pm[..., rs, :] = finish(pm[..., rs, :], m32, vhat)
            mm[..., rs, :] = m32
        vr[at] = vr_n
        vc[at] = vc_n
