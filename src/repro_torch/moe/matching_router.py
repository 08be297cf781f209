"""Token -> expert assignment as maximum-cardinality bipartite b-matching
(the JAX package's ``moe/matching_router.py``).

Token/expert assignment under expert capacity is a bipartite b-matching
problem: tokens have demand ``k`` (top-k routing), experts have capacity
``C``, edges are each token's top-m candidate experts.  The greedy
capacity-truncation router (``route_topk``, the GShard/Switch standard)
drops every (token, choice) that lands on a full expert; maximum-cardinality
matching minimizes drops over the candidate graph.

``route_matching`` is the paper's APFB machinery specialized to the
capacitated case, with fixed phases (a cascade warm start, then per phase a
level-synchronous BFS from demand-deficient tokens, a speculative parallel
alternation from slack experts, and a repair pass), so it runs inside a
model step with no host read.  ``route_matching_exact`` reduces the
instance to plain bipartite matching (a gadget graph) and solves it with
the port's :class:`~repro_torch.matching.Matcher`, on the logits' device:
on a card its BFS levels are the fused frontier kernel's launches.

The functions are the JAX ones op for op, so both packages give the same
``assign`` and ``slot`` bit for bit on the same logits:

* ``jax.lax.top_k`` puts the lower index first on ties; here a stable
  descending sort, sliced;
* ``jax.nn.one_hot(-1, n)`` is a zero row (``F.one_hot`` raises on it);
  here a compare against ``arange(n)``;
* ``jnp.argmax`` over booleans takes the first True; here the booleans are
  cast first (``torch.argmax`` also takes the first maximum);
* the ``.at[].min`` scatters are ``scatter_reduce(amin)`` into the same
  ``E + 1`` / ``T + 1`` dump slots.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.matching import Matcher, MatcherConfig, TorchCSR
from repro_torch.matching.solve import IINF

I32 = torch.int32


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def _rank_within(ids: torch.Tensor, n: int) -> torch.Tensor:
    """For each entry of the 1-D ``ids``, how many earlier entries hold the
    same id: the JAX function's ``(cumsum(onehot, 0) - onehot)[i,
    clip(ids[i], 0, n - 1)]`` with ``onehot`` of ``ids`` over ``n`` classes
    (an id outside [0, n) has a zero row).  The one-hot is built transposed,
    (n, I), so each class is scanned along a contiguous row: torch's scan
    along the outer dim of an (I, n) tensor with few columns runs a few
    threads a column (2.1 ms for (32768, 16) on an H100)."""
    onehot = (_arange(n, ids.device)[:, None] == ids[None, :]).to(I32)
    ranks = torch.cumsum(onehot, dim=1, dtype=I32) - onehot
    return ranks.gather(0, ids.clamp(0, n - 1)[None, :].long())[0]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[:, None], 1)[:, 0]``."""
    return x.gather(1, idx[:, None].long())[:, 0]


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True of each row (0 where none): ``jnp.argmax``
    over booleans."""
    return mask.to(I32).argmax(dim=1)


def _top(logits: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the ``m`` largest logits of each row, the lower index
    first among equals (``jax.lax.top_k``'s order), int32."""
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    return order[:, :m].to(I32)


def _scatter_min(n: int, index: torch.Tensor, values: torch.Tensor
                 ) -> torch.Tensor:
    """``jnp.full(n, IINF).at[index].min(values)``."""
    out = torch.full((n,), IINF, dtype=I32, device=values.device)
    return out.scatter_reduce(0, index.reshape(-1).long(),
                              values.reshape(-1).to(I32), reduce="amin")


def _combine_probs(probs: torch.Tensor, assign: torch.Tensor, E: int
                   ) -> torch.Tensor:
    p = probs.gather(1, assign.clamp(0, E - 1).long())
    p = torch.where(assign >= 0, p, 0.0)
    return p / p.sum(-1, keepdim=True).clamp_min(1e-9)


def _slot_and_evict(assign: torch.Tensor, n_experts: int, capacity: int):
    """Final feasibility pass: slot = rank of instance within its expert
    (token-major priority, as in GShard); instances with slot >= C dropped."""
    T, k = assign.shape
    flat = assign.reshape(T * k)
    slot = _rank_within(flat, n_experts)                        # exclusive
    keep = (flat >= 0) & (slot < capacity)
    flat = torch.where(keep, flat, -1)
    slot = torch.where(keep, slot, 0)
    return flat.reshape(T, k), slot.reshape(T, k)


def _dedupe(assign: torch.Tensor) -> torch.Tensor:
    """Clear duplicate experts within a token (keep first occurrence)."""
    T, k = assign.shape
    dup = torch.zeros((T, k), dtype=torch.bool, device=assign.device)
    for j in range(1, k):
        same = (assign[:, j:j + 1] == assign[:, :j]) \
            & (assign[:, j:j + 1] >= 0)
        dup[:, j] = same.any(dim=1)
    return torch.where(dup, -1, assign)


def _loads(assign: torch.Tensor, n_experts: int) -> torch.Tensor:
    flat = assign.reshape(-1)
    seg = torch.where(flat >= 0, flat, n_experts).long()
    out = torch.zeros(n_experts + 1, dtype=I32, device=assign.device)
    return out.scatter_add(0, seg, torch.ones_like(flat))[:n_experts]


def route_topk(logits: torch.Tensor, k: int, capacity: int):
    """Greedy baseline: per-choice-round capacity truncation (GShard-style)."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    cand = _top(logits, k)                                      # (T, k)
    assign, slot = _slot_and_evict(cand, E, capacity)
    p = probs.gather(1, cand.clamp(0, E - 1).long())
    p = torch.where(assign >= 0, p, 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-9)
    return assign, slot, p


def route_matching(logits: torch.Tensor, k: int, capacity: int, *,
                   n_cand: int = 0, aug_phases: int = 2, max_path: int = 8):
    """Capacitated maximum-cardinality matching router (the paper's
    technique).  Returns (assign (T,k), slot (T,k), combine_probs (T,k))."""
    T, E = logits.shape
    dev = logits.device
    m = n_cand or min(E, k + 2)                                 # candidate fan-out
    probs = torch.softmax(logits.float(), dim=-1)
    cand = _top(logits, m)                                      # (T, m)
    cand_c = cand.clamp(0, E - 1).long()
    ks, ms = _arange(k, dev)[None, :], _arange(m, dev)[None, :]

    # ---- phase 0: cascade greedy (the "cheap matching" warm start) --------
    # choice round j: every token with an unmet demand slot proposes its best
    # not-yet-used candidate; experts accept up to remaining capacity.
    assign = torch.full((T, k), -1, dtype=I32, device=dev)
    used = torch.zeros((T, m), dtype=torch.bool, device=dev)    # candidate consumed
    load = torch.zeros(E, dtype=I32, device=dev)
    for j in range(k + 2):                                      # k + retry rounds
        deficit = (assign >= 0).sum(-1) < k
        # best unused candidate with residual capacity
        cap_ok = (load[cand_c] < capacity) & ~used
        choice = _first(cap_ok)                                 # first viable
        viable = _take(cap_ok, choice) & deficit
        e_prop = torch.where(viable, _take(cand, choice), E)
        # experts accept by token-major rank within remaining capacity
        myrank = _rank_within(e_prop, E)                        # E: no expert
        e_c = e_prop.clamp(0, E - 1)
        accept = viable & (load[e_c.long()] + myrank < capacity)
        # commit: first free demand slot
        free_slot = _first(assign < 0)
        assign = torch.where(accept[:, None] & (ks == free_slot[:, None]),
                             e_prop[:, None], assign)
        picked = ms == choice[:, None]
        used = used | (accept[:, None] & picked)
        # a proposed-but-rejected candidate is NOT consumed (expert may free up
        # during augmentation) — but to guarantee round progress we consume it
        # after the k-th round:
        if j >= k:
            used = used | (viable[:, None] & picked)
        load = _loads(assign, E)

    # ---- augmentation phases (APFB adapted; BFS + speculative alternate) ---
    t_ids = _arange(T, dev)
    e_ids = _arange(E, dev)
    for _ in range(aug_phases):
        load = _loads(assign, E)
        deficit = (assign >= 0).sum(-1) < k
        has_unused = (~used & (cand < E)).any(-1)
        start_t = deficit & has_unused
        # BFS over (token, expert) alternating structure
        t_level = torch.where(start_t, 0, IINF).to(I32)         # (T,)
        e_level = torch.full((E,), IINF, dtype=I32, device=dev)
        pred_e = torch.full((E,), IINF, dtype=I32, device=dev)  # token that enters e
        pred_t = torch.full((T,), IINF, dtype=I32, device=dev)  # expert t releases
        endpoint = torch.zeros(E, dtype=torch.bool, device=dev)
        for level in range(0, max_path, 2):
            frontier_t = t_level == level
            # frontier tokens propose all unused candidates
            prop_src = torch.where(frontier_t[:, None] & ~used, cand, E)
            new_e = _scatter_min(E + 1, prop_src,
                                 t_ids[:, None].expand(T, m))[:E]
            fresh_e = (new_e < IINF) & (e_level == IINF)
            pred_e = torch.where(fresh_e, new_e, pred_e)
            e_level = torch.where(fresh_e, level + 1, e_level)
            endpoint = endpoint | (fresh_e & (load < capacity))
            # tokens assigned to freshly visited (full) experts join frontier
            assigned_fresh = (fresh_e & (load >= capacity))[
                assign.clamp(0, E - 1).long()] & (assign >= 0)  # (T, k)
            t_new = assigned_fresh.any(-1) & (t_level == IINF)
            which = _first(assigned_fresh)
            rel = _take(assign, which)
            pred_t = torch.where(t_new, rel, pred_t)
            t_level = torch.where(t_new, level + 2, t_level)
        # ---- speculative parallel alternation from slack endpoints --------
        cur_e = torch.where(endpoint, e_ids, -1)                # walker per expert
        gain_e = torch.where(endpoint, e_ids, -1)               # expert to add
        for _ in range(max_path // 2 + 1):
            active = cur_e >= 0
            t = torch.where(active, pred_e[cur_e.clamp(0, E - 1).long()],
                            IINF).to(I32)
            valid = active & (t < T)
            tc = t.clamp(0, T - 1)
            release = pred_t[tc.long()]                         # expert released
            is_root = t_level[tc.long()] == 0
            # swap: in token t, replace `release` by `gain_e` (root: fill a
            # free slot instead). Conflicts (two walkers, same token) resolve
            # by later-writer; repair pass restores feasibility.
            gain = torch.where(valid, gain_e, -1)
            upd_swap = valid & ~is_root & (release < E)
            # scatter per token: one walker wins (min expert id)
            tok_gain = _scatter_min(T + 1, torch.where(valid, tc, T),
                                    torch.where(valid, gain, IINF))[:T]
            tok_rel = _scatter_min(T + 1, torch.where(upd_swap, tc, T),
                                   torch.where(upd_swap, release, IINF))[:T]
            win = tok_gain < IINF
            # apply swap / fill
            rel_match = assign == tok_rel[:, None]
            first_rel = (torch.cumsum(rel_match, 1) == 1) & rel_match
            swapped = torch.where(
                win[:, None] & (tok_rel < IINF)[:, None] & first_rel,
                tok_gain[:, None], assign)
            free = swapped < 0
            first_free = (torch.cumsum(free, 1) == 1) & free
            assign = torch.where(
                win[:, None] & (tok_rel == IINF)[:, None] & first_free,
                tok_gain[:, None], swapped)
            # continue walk: released expert becomes the next gain
            nxt = torch.where(upd_swap, release, -1)
            cur_e = torch.where(valid & ~is_root, nxt, -1)
            gain_e = cur_e
        assign = _dedupe(assign)

    assign, slot = _slot_and_evict(assign, E, capacity)
    return assign, slot, _combine_probs(probs, assign, E)


def _gadget_graph(cand: torch.Tensor, k: int, n_experts: int,
                  capacity: int) -> TorchCSR:
    """The degree-constrained-subgraph gadget of ``route_matching_exact``
    as a :class:`TorchCSR` on ``cand``'s device, built from tensors (no
    host copy) and not bucketed, as the JAX package builds it.

    Columns: ``[T*k token clones | T*m gadget v-nodes]``; rows: ``[T*m
    gadget u-nodes | E*C expert slots]``.  Clone ``(t, j)`` sees every
    ``u_(t, c)``; ``v_(t, c)`` sees ``u_(t, c)`` and every slot of expert
    ``cand[t, c]``."""
    T, m = cand.shape
    C = capacity
    dev = cand.device
    nc = T * k + T * m
    nr = T * m + n_experts * C
    # clone edges: clone (t, j) -> u_(t, c) for every candidate c
    clone_ids = _arange(T * k, dev)
    ecol_clone = clone_ids.repeat_interleave(m)
    cadj_clone = ((clone_ids // k)[:, None] * m
                  + _arange(m, dev)[None, :]).reshape(-1)
    # gadget edges: v_(t, c) -> u_(t, c), then every slot of expert cand[t, c]
    v_cols = T * k + _arange(T * m, dev)
    ecol_v = v_cols.repeat_interleave(1 + C)
    slot_rows = (T * m + cand.reshape(-1)[:, None] * C
                 + _arange(C, dev)[None, :])                    # (T*m, C)
    cadj_v = torch.cat([_arange(T * m, dev)[:, None], slot_rows],
                       dim=1).reshape(-1)
    ecol = torch.cat([ecol_clone, ecol_v])
    cadj = torch.cat([cadj_clone, cadj_v]).to(I32)
    degrees = torch.cat([torch.full((T * k,), m, dtype=I32, device=dev),
                         torch.full((T * m,), 1 + C, dtype=I32, device=dev)])
    cxadj = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                       torch.cumsum(degrees, 0, dtype=I32)])
    return TorchCSR(cxadj=cxadj, cadj=cadj, ecol=ecol,
                    nnz=int(ecol.shape[0]), nc=nc, nr=nr)


def route_matching_exact(logits: torch.Tensor, k: int, capacity: int, *,
                         n_cand: int = 0,
                         config: Optional[MatcherConfig] = None):
    """Exact maximum-cardinality routing via the port's matcher.

    The capacitated instance (token demand ``k``, expert capacity ``C``,
    each token usable at most once per expert) is reduced to plain bipartite
    matching with the classic degree-constrained-subgraph gadget
    (:func:`_gadget_graph`); a maximum matching uses each gadget at most
    once — duplicate experts per token are structurally impossible — and its
    cardinality is ``T*m`` + the number of routed (token, expert) pairs, so
    maximum matching = minimum drops.  The graph has ``T*m*(k+1+C)`` edges
    and is solved by ``Matcher(config or MatcherConfig(), "cheap").run``
    (one compile-cache entry per shape) on the logits' device.  Returns
    (assign (T,k), slot (T,k), combine_probs (T,k)) like the other routers.
    """
    T, E = logits.shape
    m = n_cand or min(E, k + 2)
    probs = torch.softmax(logits.float(), dim=-1)
    cand = _top(logits, m)                                      # (T, m)
    graph = _gadget_graph(cand, k, E, capacity)
    state = Matcher(config or MatcherConfig(), warm_start="cheap").run(graph)

    # gadget (t, c) routed iff its v-column matched an expert slot AND its
    # u-row matched a token clone — a maximum matching may park a lone v on
    # a slot without clone backing (same cardinality), which must not route
    v_match = state.cmatch[T * k: T * k + T * m].reshape(T, m)
    u_match = state.rmatch[: T * m].reshape(T, m)
    used = (v_match >= T * m) & (u_match >= 0) & (u_match < T * k)  # (T, m)
    # compact each token's routed candidates into its k demand slots; the
    # u-backing check above bounds per-token used count by the k clones
    pos = torch.cumsum(used, dim=1, dtype=I32) - 1              # rank among used
    dest = torch.where(used, pos.clamp_max(k), k)
    assign = torch.full((T, k + 1), -1, dtype=I32, device=logits.device)
    assign.scatter_(1, dest.long(), torch.where(used, cand, -1))
    assign, slot = _slot_and_evict(assign[:, :k], E, capacity)
    return assign, slot, _combine_probs(probs, assign, E)


def router_stats(assign, k: int) -> dict:
    """Drop-rate diagnostics (used by benchmarks and tests); ``assign`` a
    tensor or a numpy array."""
    T = assign.shape[0]
    assigned = (assign >= 0).sum()
    return {
        "assigned": assigned,
        "demand": T * k,
        "drop_rate": 1.0 - assigned / (T * k),
    }
