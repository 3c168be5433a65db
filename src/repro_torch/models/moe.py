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
(``parallel.sharding.Ruleset`` places them); the setups of
``parallel.steps`` shard the experts' hidden dim under FSDP; placing the
experts over a data axis inside them (expert parallelism in the setup) and a
MoE block under tensor parallelism (experts or their hidden dim over
``model``, ``moe_buckets`` placed there) wait for ROADMAP.md M9b2b.  The
capacity factor is ``cfg.capacity_factor``;
vary it with ``dataclasses.replace``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..launch.mesh import all_to_all, pmean
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


def _group_dispatch(xg: torch.Tensor, router_w: torch.Tensor, E: int, k: int,
                    capacity: int):
    """(G, T, d) → dispatched buckets (G, E, C, d), the flat slots (G, T·k),
    combine weights (G, T, k) and aux (G,).  The buffer has one row more than
    E·C: every dropped choice is written there and the row is cut off (the
    JAX package's ``mode="drop"``)."""
    G, T, d = xg.shape
    expert_idx, combine_w, aux = _route(xg, router_w, E, k)
    slot = _dispatch_indices(expert_idx, E, capacity)
    flat_slot = slot.reshape(G, T * k)
    rows = E * capacity + 1
    target = torch.where(flat_slot >= 0, flat_slot, E * capacity) + \
        rows * torch.arange(G, device=xg.device)[:, None]
    src = xg.repeat_interleave(k, dim=1).reshape(G * T * k, d)
    buckets = xg.new_zeros((G * rows, d)).index_copy(0, target.reshape(-1), src)
    buckets = buckets.view(G, rows, d)[:, :E * capacity]
    return buckets.reshape(G, E, capacity, d), flat_slot, combine_w, aux


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


def moe_ffn(params, x: torch.Tensor, cfg, *, n_groups: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE FFN over ``n_groups`` groups of B·S/G tokens each (G = B,
    one sequence a group, by default), the capacity from a group's tokens.
    x: (B, S, d) → ((B, S, d), aux fp32 scalar, the mean of the groups' aux
    losses)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = n_groups or B
    if (B * S) % G:
        raise ValueError(f"moe_ffn: {B * S} tokens do not split into {G} groups")
    T_g = B * S // G
    capacity = capacity_of(T_g, cfg)
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
