"""AdamW with fp32 master state and global-norm clipping (the JAX
package's ``optim/adamw.py``).

The state is a nested dict of tensors with the JAX package's keys, so a
checkpoint maps leaf for leaf: ``m``, ``v``, ``step`` and, with
``master_fp32``, ``master``; in the ``factored`` branch (an
Adafactor-style row/column second moment and a bf16 first moment) ``m``,
``vr``, ``vc`` and ``step``.  ``step`` is a 0-d int32 tensor.

ZeRO-1 over a world's ranks (the JAX module's ``_zero1_spec`` on the data
axis): with ``world``, rank ``r`` keeps the ``r``-th slice of every state
leaf (``m``, ``v``, ``master``; factored: ``m``, ``vr``, ``vc``) along
:func:`zero1_dim` of its parameter, the first dim the world's size divides
(the reference's spec once ``sanitize_spec`` has moved the axis to a dim
that divides); for a factorable leaf of the factored branch, not one of its
last two, so that ``vr``, ``vc`` and ``vr.mean(-1)`` stay whole within the
slice.  A leaf with no such dim keeps its state whole on every rank (each
rank then updates it whole, from the same mean gradient, to the same
values).  ``adamw_update`` then takes the gradients already cut
(:func:`repro_torch.distributed.reduce_scatter_mean`, or the whole mean
where the state is whole), clips by the global norm (the square root of
``all_reduce_sum_`` of the ranks' sums over their slices, plus the whole
leaves' once), updates its slices in place and gathers the new parameter
slices into the whole parameters (``all_gather_into``).  The values are the
one-device update's, up to the order of the norm's sum.

Over a world of ``D x M`` ranks (``places``, the model's
:func:`~repro_torch.models.common.leaf_place` tree): ``params`` are this
rank's slices; ZeRO-1 cuts over the ``data`` axis only, on a dim the model
axis leaves free, and skips FSDP leaves (the reference's ``_zero1_spec``),
whose state is cut as the parameter is and which are not gathered after
the update.  The global norm counts each leaf once: the model-cut and
data-cut parts summed over their axes, a leaf whole on every rank once.
In the factored branch, where an axis cuts one of a leaf's last two dims
(``wq``'s heads at ``(D, H, hd)``, an FSDP dim), ``vr``, ``vc`` and
``vr.mean(-1)`` are reduced over that axis, each rank taking its slabs by
the axis's block, so that a rank whose block is short or empty (a model
axis that does not divide the heads) joins the same collectives.

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
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.comm import all_gather_into, all_reduce_sum_
from repro_torch.models.common import Place, tree_leaves, tree_map

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


def _whole(p: torch.Tensor, pl: Place) -> tuple:
    """The whole shape of the leaf of which ``p`` is a rank's part (its
    factored moments are the whole leaf's: a cut K/V head dim of one is
    still a factorable leaf's)."""
    shape = list(p.shape)
    for dim, _, whole, _ in pl.cuts:
        shape[dim] = whole
    return tuple(shape)


def zero1_dim(shape: Sequence[int], ranks: int,
              factored: bool = False, skip: Optional[int] = None,
              whole: Optional[Sequence[int]] = None) -> Optional[int]:
    """The dim along which ZeRO-1 cuts the optimizer state of a leaf of
    ``shape`` over ``ranks`` ranks: the first dim ``ranks`` divides (with
    ``factored``, for a factorable leaf, judged by its ``whole`` shape, not
    one of its last two; never ``skip``, the dim the model axis cuts);
    None where there is none, the state then kept whole."""
    fact = _factorable(shape if whole is None else whole)
    dims = len(shape) - (2 if factored and fact else 0)
    for d in range(dims):
        if d != skip and shape[d] and shape[d] % ranks == 0:
            return d
    return None


def _places(params, places):
    """``places``, or every leaf whole (one device, or the data axis
    alone)."""
    return places if places is not None else tree_map(lambda _: Place(),
                                                      params)


def zero1_dims(params, cfg: OptConfig, world, places=None):
    """:func:`zero1_dim` of every leaf of ``params`` over ``world``'s data
    axis (a tree of the same structure; ``world`` None: every leaf whole;
    an FSDP leaf of ``places``: None, its state cut as it is)."""
    if world is None:
        return tree_map(lambda p: None, params)
    it = iter(tree_leaves(_places(params, places)))

    def dim(p):
        pl = next(it)
        if pl.data is not None:
            return None
        return zero1_dim(tuple(p.shape), world.data.size, cfg.factored,
                         skip=pl.model, whole=_whole(p, pl))

    return tree_map(dim, params)


def state_cuts(params, cfg: OptConfig, world, places) -> Dict[str, Any]:
    """Every state leaf's cuts over the world (a tree like the state's, of
    :data:`~repro_torch.models.common.Cut` tuples, for
    ``save_checkpoint(..., dims=)`` and ``restore_checkpoint``): the
    parameter's model and FSDP cuts and its ZeRO-1 cut over ``data``;
    ``vr`` without a cut of the last dim (reduced over it), ``vc`` without
    one of the second-last, a non-factorable leaf's ``vc`` and ``step``
    whole."""
    places = _places(params, places)
    zd = iter(tree_leaves(zero1_dims(params, cfg, world, places)))
    pl = iter(tree_leaves(places))
    fact = iter([_factorable(_whole(p, q)) for p, q in zip(
        tree_leaves(params), tree_leaves(places))] * 2)
    d = world.data.size

    def full(p):
        cuts, z = next(pl).cuts, next(zd)
        if z is not None:
            cuts += ((z, "data", p.shape[z], p.shape[z] // d),)
        return cuts

    moments = tree_map(full, params)
    if not cfg.factored:
        out = {"m": moments, "v": moments, "step": ()}
        if cfg.master_fp32:
            out["master"] = moments
        return out

    def vr(p, cuts):
        if not next(fact):
            return cuts
        return tuple(c for c in cuts if c[0] != p.dim() - 1)

    def vc(p, cuts):
        if not next(fact):
            return ()
        n = p.dim()
        return tuple((c[0] - 1,) + c[1:] if c[0] == n - 1 else c
                     for c in cuts if c[0] != n - 2)

    def both(fn):
        it = iter(tree_leaves(moments))
        return tree_map(lambda p: fn(p, next(it)), params)

    return {"m": moments, "vr": both(vr), "vc": both(vc), "step": ()}


def rank_slice(t: torch.Tensor, dim: Optional[int], world) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` over ``world``'s data axis
    (a view; ``t`` itself where ``dim`` is None)."""
    if dim is None:
        return t
    data = world.data
    k = t.shape[dim] // data.size
    return t.narrow(dim, data.rank * k, k)


def adamw_init(params, cfg: OptConfig, world=None, places=None
               ) -> Dict[str, Any]:
    """The zero state of ``params`` (on their devices); with ``world``,
    this rank's ZeRO-1 slices of it (module doc)."""
    fact = iter([_factorable(_whole(p, q)) for p, q in zip(
        tree_leaves(params), tree_leaves(_places(params, places)))] * 2)
    if world is not None:
        it = iter(tree_leaves(zero1_dims(params, cfg, world, places)))
        params = tree_map(lambda p: rank_slice(p, next(it), world), params)
    dev = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.factored:
        def mk_vr(p):   # row second moment (last dim reduced)
            shape = p.shape[:-1] if next(fact) else p.shape
            return p.new_zeros(shape, dtype=torch.float32)

        def mk_vc(p):   # col second moment (second-to-last reduced)
            if next(fact):
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
    """:data:`CPU_BLOCK` on the CPU, else :data:`SLAB` (the card's; on
    ``meta`` the dry run prices the card's update)."""
    return CPU_BLOCK if t.device.type == "cpu" else SLAB


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
def adamw_update(params, grads, state, cfg: OptConfig, world=None,
                 places=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``(params, state, {"grad_norm", "lr"})``
    with ``params`` and ``state`` the trees given, updated.  The JAX
    function's order of operations: the global norm of the fp32 grads,
    ``scale = min(1, clip / max(gnorm, 1e-9))``, the learning rate from
    the step before the increment, the bias corrections from the step
    after.  With ``world``: ``grads`` and ``state`` are this rank's ZeRO-1
    slices, ``params`` whole over the data axis, or over a model axis
    this rank's slices (``places``; module doc)."""
    places = _places(params, places)
    dims = zero1_dims(params, cfg, world, places)
    if world is None:
        gnorm = torch.sqrt(sum(_square_sum(g) for g in _sorted_leaves(grads)))
    else:
        gnorm = _world_norm(grads, dims, places, world)
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

    work: dict = {}
    if cfg.factored:
        leaves = _zip(params, grads, state["m"], state["vr"], state["vc"])
        update = _factored_update
    else:
        leaves = _zip(params, grads, state["m"], state["v"],
                      state.get("master", params))
        update = _plain_update
    has_master = "master" in state
    for (p, *rest), (d, pl) in zip(leaves, _zip(dims, places)):
        mine = rank_slice(p, d, world)
        if d is not None:
            mine = mine.contiguous()
            if not cfg.factored and not has_master:
                rest[-1] = mine              # w: the slice it updates
        if cfg.factored:
            rest.append((_factorable(_whole(p, pl)),
                         _last_two_cuts(pl, p.dim(), world),
                         _slab_shape(tuple(mine.shape), pl)))
        update(cfg, scale, finish, has_master, mine, *rest, work)
        if d is not None:
            all_gather_into(p, mine, d, world.data)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _last_two_cuts(pl: Place, ndim: int, world) -> tuple:
    """For the factored moments: ``(axis, whole length)`` of the axis that
    cuts the leaf's last dim and of the one that cuts its second-last
    (None where none does)."""
    out = []
    for dim in (ndim - 1, ndim - 2):
        cut = next((c for c in pl.cuts if c[0] == dim), None)
        out.append(None if cut is None or world is None else
                   (getattr(world, cut[1]),
                    cut[2]))
    return tuple(out)


def _slab_shape(shape, pl: Place) -> tuple:
    """``shape`` (a rank's part of a leaf) with each of its last two dims
    that an axis cuts taken at the axis's block: every rank of the axis
    then takes the same slabs (:func:`_matrices`), so that the factored
    moments' collectives pair up where a rank's block is short or
    empty."""
    out = list(shape)
    for dim, _, _, block in pl.cuts:
        if dim >= len(out) - 2:
            out[dim] = block
    return tuple(out)


def _world_norm(grads, dims, places, world) -> torch.Tensor:
    """The global gradient norm over a world, each leaf counted once (in
    the JAX package's leaf order): the ranks' sums of squares over their
    parts, a part summed on the ranks that hold it (a leaf whole over an
    axis counted on its rank 0 of that axis), by one ``all_reduce_sum_``
    over the world; then the leaves whole on every rank, once."""
    rows = list(zip(_sorted_leaves(grads), _sorted_leaves(dims),
                    _sorted_leaves(places)))
    part = torch.zeros((), dtype=torch.float32, device=rows[0][0].device)
    for g, d, pl in rows:
        model_cut, data_cut = pl.model is not None, (
            d is not None or pl.data is not None)
        if not (model_cut or data_cut):
            continue
        if (model_cut or world.model.rank == 0) and \
                (data_cut or world.data.rank == 0):
            part = part + _square_sum(g)
    all_reduce_sum_(part, world)
    for g, d, pl in rows:
        if d is None and pl.model is None and pl.data is None:
            part = part + _square_sum(g)
    return torch.sqrt(part)


def _plain_update(cfg, scale, finish, has_master, p, g, m, v, w, work
                  ) -> None:
    """The update of one leaf with fp32 ``m`` and ``v`` (and masters
    ``w``, else ``w`` is ``p``), a block at a time."""
    ins = [_flat(t) for t in (g, m, v, w)]
    o = [_flat_out(t) for t in ((p, m, v, w) if has_master else (p, m, v))]
    for sl in _blocks(p.numel(), _block(p)):
        gb, mb, vb, wb = (t[sl] for t in ins)
        gb = gb.float() * scale
        m_n = cfg.b1 * mb + (1 - cfg.b1) * gb
        v_n = cfg.b2 * vb + (1 - cfg.b2) * gb.square()
        w32 = finish(wb, m_n, v_n)
        for out, val in zip(o, (w32, m_n, v_n, w32)):
            out[sl] = val


def _factored_update(cfg, scale, finish, has_master, p, g, m, vr, vc, how,
                     work) -> None:
    """The factored update of one leaf: :func:`_factored_leaf` for a
    factorable one, else elementwise with ``vr`` as its second moment.
    ``how``: (factorable, the cuts of the last two dims, the shape its
    slabs are taken by, :func:`_slab_shape`)."""
    factorable, cuts, slabs = how
    if factorable:
        _factored_leaf(cfg, scale, finish, p, g, m, vr, vc, work, cuts,
                       slabs)
        return
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


def _mean(t: torch.Tensor, dim: int, cut) -> torch.Tensor:
    """``t.mean(dim)``, over every rank's part of the dim where ``cut``
    (``(axis, whole length)``) says an axis cuts it."""
    if cut is None:
        return t.mean(dim)
    axis, whole = cut
    return all_reduce_sum_(t.sum(dim), axis).div_(whole)


def _factored_leaf(cfg, scale, finish, p, g, m, vr, vc, work: dict,
                   cuts=(None, None), slabs=None) -> None:
    """The factored update of a factorable leaf, a slab of whole matrices
    at a time: the row and column moments from the slab's squared
    gradient, then the elementwise rest in blocks of rows.  The slab's two
    fp32 temporaries live in ``work``, reused from slab to slab (on the
    CPU a fresh allocation of that size costs more than the arithmetic).
    ``cuts``: the axes cutting the last and second-last dims (module
    doc); ``slabs``: the shape the slabs are taken by (``p``'s where
    None)."""
    c = p.shape[-1]
    last, second = cuts
    for at in _matrices(tuple(p.shape) if slabs is None else slabs):
        ga = g[at]
        gs = torch.mul(ga.float(), scale, out=_work(work, 0, ga))
        g2 = torch.square(gs, out=_work(work, 1, ga)).add_(1e-30)
        vr_n = cfg.b2 * vr[at] + (1 - cfg.b2) * _mean(g2, -1, last)
        vc_n = cfg.b2 * vc[at] + (1 - cfg.b2) * _mean(g2, -2, second)
        del g2
        vmean = torch.clamp(_mean(vr_n, -1, second)[..., None, None],
                            min=1e-30)
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
