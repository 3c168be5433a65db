"""Mixture-of-Experts FFN (mixtral / arctic style).

Counterpart of ``repro.models.moe``.  Dispatch is *sort-based*
(dropless-up-to-capacity): each token's k expert choices are stably sorted by
expert id, a choice's place inside its expert's bucket falls out of the sorted
order, and tokens are scattered into / gathered from dense (E, C, d) buffers,
one set per group of tokens.  Choices past an expert's capacity C are dropped:
they add nothing to the token's output.

The JAX package ``vmap``-s route → dispatch → combine over G groups of
T_g = B·S/G tokens (G = B, one sequence a group, by default; ``n_groups=``
chooses another G, and the capacity follows T_g); here every step is batched
over the leading G axis directly.  The expert products stay library products
(``torch.einsum`` over ``(G, E, C, d)``), as the JAX package computes them
outside any Pallas kernel.  The router aux loss follows Switch Transformer
(fraction of tokens x mean probability, summed over experts, times E).

``jax.lax.top_k`` takes the lower expert index of two equal probabilities;
``torch.topk`` promises no order among ties, so ``_route`` takes the top k of
a stable descending sort instead.

``moe_ffn_ep`` is the expert-parallel FFN, the paper's All-to-All pattern
(Sec. II-C): the experts shard over a data axis of a ``launch.mesh`` mesh,
each rank routes its own tokens as one group, an all-to-all gives every rank
its E/n experts' buckets from all n ranks, the expert products run on the
local weight shard, and the inverse all-to-all brings the outputs back for
the combine.  Routing, capacity and combine are ``moe_ffn``'s, so it equals
``moe_ffn(n_groups=n)``.  Its gradients flow through both exchanges
(``launch.mesh.all_to_all``).  The experts' logical axes are ``moe_axes``
(``parallel.sharding.Ruleset`` places them).  The capacity factor is
``cfg.capacity_factor``; vary it with ``dataclasses.replace``.

Tensor parallelism (``moe_ffn(tp=)``, a ``parallel.tp.TPContext``): Megatron's
split over the rows form of the TP axis.  Where the experts divide the TP
degree a rank holds its E / tp experts' ``w_gate`` / ``w_up`` / ``w_down``,
otherwise every expert's columns of ``w_gate`` / ``w_up`` and rows of
``w_down``; arctic's ``dense`` residual is split column / row on
``mlp_dense``.  The router runs once, on the whole input, outside the ranks:
the routing, the aux loss and the bucket slots are computed once.  The
input and the combine weights reach the ranks through f (``tp.copy``), so
that their gradients are summed by the all-reduce on both meshes; each rank
fills the buckets of the experts it holds from its copy of the input at the
shared slots (an integer-indexed scatter, so f sits on its input, whose
gradient is smaller than the buckets'), runs its experts and combines its
partial; its partial of the dense residual is added, and one g
(``tp.reduce``, one tree-reduce launch) sums the ranks.

Expert parallelism inside the setups (``moe_ffn_lanes``): the lanes of an EP
group (the ranks of the EP axis, each with its own sequences) run the FFN
together.  Each lane routes its own sequences, one group a sequence (the
capacity of ``moe_ffn``'s default), the all-to-all hands each lane its E / n
experts' buckets from every lane, the experts run on the local shard (and
under TP on the rank's ``mlp`` block), and the inverse all-to-all brings the
outputs back for the combine.  So it equals ``moe_ffn`` of the whole batch
with one group a sequence.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..launch.mesh import all_to_all, in_turns, jointly, pmean
from .modules import dense_init, swiglu


def _expert_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """(E, a, b) expert weights, each expert drawn on its own so that no fp32
    copy of the whole stack exists (arctic's w_gate is 4.5e9 values).  The
    fan-in is the JAX package's rule for a 3-D shape: E x a."""
    E, a, b = shape
    std = 1.0 / math.sqrt(max(E * a, 1))
    w = torch.empty(shape, dtype=dtype, device=device)
    for e in range(E):
        w[e] = dense_init(gen, (a, b), scale=std, dtype=dtype, device=device)
    return w


def init_moe(gen: torch.Generator, cfg, dtype=torch.float32,
             device="cuda") -> Dict[str, object]:
    """Router, expert SwiGLU weights and (arctic) the dense residual FFN."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    params: Dict[str, object] = {
        "router": dense_init(gen, (d, E), scale=0.02, **kw),
        "w_gate": _expert_init(gen, (E, d, f), **kw),
        "w_up": _expert_init(gen, (E, d, f), **kw),
        "w_down": _expert_init(gen, (E, f, d), **kw),
    }
    if cfg.moe_dense_ff:
        fd = cfg.moe_dense_ff
        params["dense"] = {
            "w_gate": dense_init(gen, (d, fd), **kw),
            "w_up": dense_init(gen, (d, fd), **kw),
            "w_down": dense_init(gen, (fd, d), **kw),
        }
    return params


def moe_axes(cfg) -> Dict[str, object]:
    """The logical axes of ``init_moe``'s tensors; arctic's dense residual has
    its own names (``embed_unsharded``, ``mlp_dense``): the rule table keeps
    its contraction dim whole."""
    p: Dict[str, object] = {"router": ("embed", "expert_router"),
                            "w_gate": ("expert", "embed", "mlp"),
                            "w_up": ("expert", "embed", "mlp"),
                            "w_down": ("expert", "mlp", "embed")}
    if cfg.moe_dense_ff:
        p["dense"] = {"w_gate": ("embed_unsharded", "mlp_dense"),
                      "w_up": ("embed_unsharded", "mlp_dense"),
                      "w_down": ("mlp_dense", "embed_unsharded")}
    return p


def _route(x: torch.Tensor, router_w: torch.Tensor, n_experts: int, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., T, d) tokens → (expert_idx (..., T, k), combine_w (..., T, k),
    aux (...)), every leading index a group of its own.  The router runs in
    fp32."""
    logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    # stable descending sort: of two equal probabilities the lower expert
    # index comes first, as jax.lax.top_k has it
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    combine_w, expert_idx = vals[..., :top_k], idx[..., :top_k]
    combine_w = combine_w / combine_w.sum(dim=-1, keepdim=True)
    T = x.shape[-2]
    counts = torch.zeros(probs.shape[:-2] + (n_experts,), dtype=torch.float32,
                         device=x.device)
    counts.scatter_add_(-1, expert_idx.reshape(*probs.shape[:-2], -1),
                        torch.ones(expert_idx.shape, dtype=torch.float32,
                                   device=x.device).reshape(*probs.shape[:-2], -1))
    frac_tokens = counts / (T * top_k)
    frac_probs = probs.mean(dim=-2)
    aux = n_experts * (frac_tokens * frac_probs).sum(dim=-1)
    return expert_idx, combine_w, aux


def _dispatch_indices(expert_idx: torch.Tensor, n_experts: int,
                      capacity: int) -> torch.Tensor:
    """Sort-based bucket slots.  expert_idx: (..., T, k) → slot (..., T, k)
    in the flat (E·C) buffer of its group, or -1 where the expert's bucket
    was full (the choice is dropped).  A choice's place in its bucket is its
    rank among the group's choices of that expert in (token, k) order."""
    *lead, T, k = expert_idx.shape
    flat_e = expert_idx.reshape(*lead, T * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    experts = torch.arange(n_experts, device=flat_e.device).expand(*lead, n_experts)
    first = torch.searchsorted(sorted_e.contiguous(), experts.contiguous(), side="left")
    pos_sorted = torch.arange(T * k, device=flat_e.device) - torch.gather(first, -1, sorted_e)
    pos = torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)
    slot = torch.where(pos < capacity, flat_e * capacity + pos, -1)
    return slot.reshape(*lead, T, k)


def _route_slots(xg: torch.Tensor, router_w: torch.Tensor, E: int, k: int,
                 capacity: int):
    """Routing and bucket slots of (G, T, d) groups: the flat slots (G, T·k),
    combine weights (G, T, k) and aux (G,)."""
    expert_idx, combine_w, aux = _route(xg, router_w, E, k)
    slot = _dispatch_indices(expert_idx, E, capacity)
    return slot.reshape(xg.shape[0], -1), combine_w, aux


def _fill_buckets(xg: torch.Tensor, flat_slot: torch.Tensor, n_experts: int,
                  capacity: int, k: int) -> torch.Tensor:
    """(G, T, d) tokens → (G, n_experts, C, d) buckets, each choice at its
    slot of ``flat_slot`` (G, T·k) in the flat (n_experts·C) buffer.  The
    buffer has one row more: every choice at slot -1 (dropped, or another
    rank's expert) is written there and the row is cut off (the JAX
    package's ``mode="drop"``)."""
    G, T, d = xg.shape
    rows = n_experts * capacity + 1
    target = torch.where(flat_slot >= 0, flat_slot, n_experts * capacity) + \
        rows * torch.arange(G, device=xg.device)[:, None]
    src = xg.repeat_interleave(k, dim=1).reshape(G * T * k, d)
    buckets = xg.new_zeros((G * rows, d)).index_copy(0, target.reshape(-1), src)
    buckets = buckets.view(G, rows, d)[:, :n_experts * capacity]
    return buckets.reshape(G, n_experts, capacity, d)


def _group_dispatch(xg: torch.Tensor, router_w: torch.Tensor, E: int, k: int,
                    capacity: int):
    """(G, T, d) → dispatched buckets (G, E, C, d), the flat slots (G, T·k),
    combine weights (G, T, k) and aux (G,)."""
    flat_slot, combine_w, aux = _route_slots(xg, router_w, E, k, capacity)
    return _fill_buckets(xg, flat_slot, E, capacity, k), flat_slot, combine_w, aux


def _local_slots(flat_slot: torch.Tensor, first: int, n: int, capacity: int) -> torch.Tensor:
    """The slots of experts ``first`` .. ``first + n - 1`` in their own
    (n·C) buffer; -1 for the other experts' choices and the dropped ones."""
    lo = first * capacity
    inside = (flat_slot >= lo) & (flat_slot < lo + n * capacity)
    return torch.where(inside, flat_slot - lo, -1)


def _group_combine(y_e: torch.Tensor, flat_slot: torch.Tensor,
                   combine_w: torch.Tensor, T: int, k: int) -> torch.Tensor:
    """Inverse of the dispatch: (G, E·C, d) expert outputs → (G, T, d), each
    token the combine-weighted sum of its k kept choices."""
    G, _, d = y_e.shape
    safe = flat_slot.clamp_min(0)
    w = torch.where(flat_slot >= 0, combine_w.reshape(G, T * k), 0.0)
    gathered = torch.gather(y_e, 1, safe[..., None].expand(G, T * k, d))
    gathered = gathered * w[..., None].to(y_e.dtype)
    return gathered.reshape(G, T, k, d).sum(dim=2)


def capacity_of(tokens_per_group: int, cfg) -> int:
    """Slots an expert has in a group: ceil(T_g·k·cf / E) with cf =
    ``cfg.capacity_factor``, at least 4, rounded up to a multiple of 4."""
    c = max(int(math.ceil(tokens_per_group * cfg.top_k * cfg.capacity_factor
                          / cfg.n_experts)), 4)
    return -(-c // 4) * 4


def _experts(params, buckets: torch.Tensor, up: str, down: str) -> torch.Tensor:
    """The expert SwiGLU over dispatched buckets, ``up`` / ``down`` the
    einsums of the layout."""
    g = torch.einsum(up, buckets, params["w_gate"])
    u = torch.einsum(up, buckets, params["w_up"])
    return torch.einsum(down, swiglu(g, u), params["w_down"])


def _dense_residual(params, x: torch.Tensor) -> torch.Tensor:
    """Arctic's dense residual FFN on every token of x (..., d)."""
    dn, d = params["dense"], x.shape[-1]
    x2d = x.reshape(-1, d)
    return (swiglu(x2d @ dn["w_gate"], x2d @ dn["w_up"]) @ dn["w_down"]).reshape(x.shape)


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def moe_ffn(params, x: torch.Tensor, cfg, *, n_groups: Optional[int] = None, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE FFN over ``n_groups`` groups of B·S/G tokens each (G = B,
    one sequence a group, by default), the capacity from a group's tokens.
    x: (B, S, d) → ((B, S, d), aux fp32 scalar, the mean of the groups' aux
    losses).  With ``tp`` the expert leaves and ``dense`` are in the rows
    form over the TP axis (``_moe_ffn_tp``); x, the router and the result
    are whole."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = n_groups or B
    if (B * S) % G:
        raise ValueError(f"moe_ffn: {B * S} tokens do not split into {G} groups")
    T_g = B * S // G
    capacity = capacity_of(T_g, cfg)
    if tp is not None:
        out, aux = _moe_ffn_tp(params, x.reshape(G, T_g, d), cfg, capacity, tp)
        return out.reshape(B, S, d), aux.mean()
    buckets, flat_slot, combine_w, aux = _group_dispatch(
        x.reshape(G, T_g, d), params["router"], E, k, capacity)
    y = _experts(params, buckets, "gecd,edf->gecf", "gecf,efd->gecd")
    out = _group_combine(y.reshape(G, E * capacity, d), flat_slot, combine_w,
                         T_g, k).reshape(B, S, d)
    if cfg.moe_dense_ff:
        out = out + _dense_residual(params, x)
    return out, aux.mean()


def moe_ffn_ep(params, x: torch.Tensor, cfg, *, mesh, ep_axis: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN over the ``ep_axis`` of ``mesh`` (n ranks).

    Takes and returns the rows form of ``launch.mesh`` over ``(ep_axis,)``
    (what ``parallel.sharding.shard_leaf`` gives; R = n on a ``StackedMesh``,
    1 on a ``DistMesh``): x (R, B/n, S, d), the ranks' own tokens; the expert
    weights ``w_gate`` / ``w_up`` / ``w_down`` (R, E/n, ...), the ranks'
    experts; the router and arctic's ``dense`` whole.  Each rank routes its
    B/n·S tokens as one group (the capacity from them), builds (E, C, d)
    buckets, and the all-to-all leaves it (E/n, n·C, d): its experts'
    buckets from every rank, rank j's in slots j·C ... The expert products
    run on the local shard; the inverse all-to-all and the combine follow,
    then the dense residual on the rank's own tokens.  Returns ((R, B/n, S,
    d), aux), aux the mean of the ranks' aux losses (``pmean``).

    Equals ``moe_ffn(n_groups=n)`` of the whole batch (rank r's tokens are
    group r).  Raises ``ValueError`` unless n divides both B and E.
    """
    if ep_axis not in mesh.shape:
        raise ValueError(f"moe_ffn_ep: ep_axis {ep_axis!r} is not an axis of {mesh.axis_names}")
    n, R = mesh.shape[ep_axis], mesh.rows((ep_axis,))
    E, k = cfg.n_experts, cfg.top_k
    if E % n or x.dim() != 4 or x.shape[0] != R:
        raise ValueError(f"moe_ffn_ep: batch and n_experts {E} must both divide over "
                         f"ep_axis {ep_axis!r} (size {n}); x {tuple(x.shape)} must be "
                         f"({R}, B/{n}, S, d), the batch placed by shard_leaf")
    b, S, d = x.shape[1:]
    for name in ("w_gate", "w_up", "w_down"):
        if params[name].shape[:2] != (R, E // n):
            raise ValueError(f"moe_ffn_ep: {name} {tuple(params[name].shape)} is not "
                             f"({R}, {E // n}, ...): shard the experts over {ep_axis!r}")
    T = b * S
    capacity = capacity_of(T, cfg)
    buckets, flat_slot, combine_w, aux = _group_dispatch(
        x.reshape(R, T, d), params["router"], E, k, capacity)
    # dispatch: block j (experts j·E/n ...) to rank j; keep every rank's
    # slots of the local experts, sender-major
    got = all_to_all(mesh, buckets.view(R, n, E // n, capacity, d), (ep_axis,))
    local = got.transpose(1, 2).reshape(R, E // n, n * capacity, d)
    y = _experts(params, local, "recd,redf->recf", "recf,refd->recd")
    # combine: the exact inverse exchange
    back = all_to_all(mesh, y.view(R, E // n, n, capacity, d).transpose(1, 2),
                      (ep_axis,))
    out = _group_combine(back.reshape(R, E * capacity, d), flat_slot, combine_w,
                         T, k).reshape(x.shape)
    if cfg.moe_dense_ff:
        out = out + _dense_residual(params, x)
    return out, pmean(mesh, aux, (ep_axis,))


def _row(tree, r: int):
    """Row ``r`` of every tensor of a (nested) dictionary in the rows form."""
    return {n: _row(v, r) if isinstance(v, dict) else v[r] for n, v in tree.items()}


def _moe_ffn_tp(params, xg: torch.Tensor, cfg, capacity: int, tp):
    """``moe_ffn`` of a TP group on (G, T, d) groups: the routing and the
    slots once, on the whole input; then each rank of the rows form in turn
    fills the buckets of the experts it holds (E / tp of them where they
    divide the degree, else every expert's ``mlp`` block) from its copy of
    the input (f), runs them, combines its partial with the combine weights
    (f) and adds its partial of the dense residual; g sums the ranks.
    Returns ((G, T, d), aux (G,))."""
    G, T, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    flat_slot, combine_w, aux = _route_slots(xg, params["router"], E, k, capacity)
    xr, cw = tp.copy(xg), tp.copy(combine_w)
    held = params["w_gate"].shape[1]
    parts = []
    for r, c in enumerate(tp.mesh.row_coords(tp.axis)):
        slot = flat_slot if held == E else _local_slots(flat_slot, c * held, held, capacity)
        buckets = _fill_buckets(xr[r], slot, held, capacity, k)
        y = _experts({n: params[n][r] for n in EXPERT_LEAVES}, buckets,
                     "gecd,edf->gecf", "gecf,efd->gecd")
        out = _group_combine(y.reshape(G, held * capacity, d), slot, cw[r], T, k)
        if cfg.moe_dense_ff:
            out = out + _dense_residual({"dense": _row(params["dense"], r)}, xr[r])
        parts.append(out)
    return tp.reduce(torch.stack(parts)), aux


def moe_ffn_lanes(lanes, ys, cfg, *, ep, tp=None):
    """The MoE FFN of the lanes of an expert-parallel group (``ep``, a
    ``parallel.tp.EPContext``: the ranks of a data axis, every one on a
    ``StackedMesh``, this rank on a ``DistMesh``), as the setups of
    ``parallel.steps`` run it.

    ``ys``: each lane's (b, S, d) input (its own sequences); ``lanes``: each
    lane's FFN parameters, the router and arctic's ``dense`` the lane's own
    copies (under ``tp`` ``dense`` in the rows form over the TP axis), the
    expert leaves the rows form of ``('data', None, 'model')`` (the lanes'
    E / n experts, under ``tp`` their ``mlp`` blocks), one tensor for every
    lane.  Each lane routes its sequences one group a sequence (the capacity
    of S tokens), fills its (b, E, C, d) buckets; the all-to-all over the EP
    axis hands each lane its experts' buckets from every lane (sender-major,
    then sequence); the experts run; the inverse all-to-all and the combine
    follow.  Under ``tp`` the routing is the lane's, once; the input and the
    combine weights reach the TP ranks through f, every TP rank exchanges
    and runs its ``mlp`` block, and one g sums its partial (with the dense
    residual's).  Returns (each lane's (b, S, d) output, aux (lanes,): each
    lane's mean over its sequences).  Equals ``moe_ffn`` of the lanes'
    sequences one group a sequence."""
    R, n = ep.rows, ep.size
    E, k = cfg.n_experts, cfg.top_k
    if E % n or len(ys) != R or len(lanes) != R:
        raise ValueError(f"moe_ffn_lanes: {E} experts over {n} ranks of {ep.axis!r}, "
                         f"{len(ys)} lanes given, {R} expected")
    b, S, d = ys[0].shape
    C = capacity_of(S, cfg)
    w = {nm: lanes[0][nm].view(R, -1, *lanes[0][nm].shape[1:]) for nm in EXPERT_LEAVES}
    if w["w_gate"].shape[2] != E // n:
        raise ValueError(f"moe_ffn_lanes: w_gate {tuple(lanes[0]['w_gate'].shape)} does not "
                         f"hold {E // n} experts a rank of {ep.axis!r}")
    routed = [_route_slots(y, lane["router"], E, k, C) for y, lane in zip(ys, lanes)]
    if tp is None:
        yr = [y[None] for y in ys]
        cws = [cw[None] for _, cw, _ in routed]
        dense = [{"dense": lane["dense"]} for lane in lanes] if cfg.moe_dense_ff else None
    else:
        yr = [tp.copy(y) for y in ys]
        cws = [tp.copy(cw) for _, cw, _ in routed]
    parts = [[] for _ in range(R)]
    T = w["w_gate"].shape[1]
    for t in range(T):
        buckets = torch.stack([_fill_buckets(yr[r][t], routed[r][0], E, C, k)
                               for r in range(R)])
        # dispatch: lane j's experts' block to lane j; keep every lane's
        # buckets of the local experts, sender-major.  Counted as the R
        # lanes' exchange of one of the T TP blocks (launch.mesh.in_turns)
        send = buckets.view(R, b, n, E // n, C, d).transpose(1, 2)
        with in_turns(T), jointly(R):
            got = all_to_all(ep.mesh, send, (ep.axis,))
        local = got.permute(0, 3, 1, 2, 4, 5).reshape(R, E // n, n * b * C, d)
        y = _experts({nm: v[:, t] for nm, v in w.items()}, local,
                     "recd,redf->recf", "recf,refd->recd")
        # combine: the exact inverse exchange
        with in_turns(T), jointly(R):
            back = all_to_all(ep.mesh,
                              y.view(R, E // n, n, b, C, d).permute(0, 2, 3, 1, 4, 5),
                              (ep.axis,))
        mine = back.permute(0, 2, 1, 3, 4, 5).reshape(R, b, E * C, d)
        for r in range(R):
            out = _group_combine(mine[r], routed[r][0], cws[r][t], S, k)
            if cfg.moe_dense_ff:
                dn = dense[r] if tp is None else {"dense": _row(lanes[r]["dense"], t)}
                out = out + _dense_residual(dn, yr[r][t])
            parts[r].append(out)
    outs = [p[0] if tp is None else tp.reduce(torch.stack(p)) for p in parts]
    return outs, torch.stack([aux.mean() for _, _, aux in routed])
