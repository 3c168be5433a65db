"""FRED-style gradient synchronisation schedules over a mesh's transport.

Counterpart of ``repro.parallel.collectives``, where the functions run inside
``shard_map`` bodies.  Here each function takes the mesh (``launch.mesh``) and
runs its schedule over the mesh's transport: the stacked one (every replica
on one device; an exchange or gather is a strided view) or the distributed
one (one replica per ``torch.distributed`` rank).  The schedules are written
once, over three transport steps and the kernels of ``kernels.ops``:

* reduce-scatter = ``mesh.exchange`` (all-to-all of G chunks) and
  ``ops.reduce_shards`` (the tree-reduce kernel) over what arrived;
* all-reduce of a scattered shard = ``mesh.gather`` and ``ops.reduce_shards``;
* all-gather = ``mesh.gather``.

``build_shard_sync`` is the same reduction for a gradient that stays sharded
(FSDP): each leaf's sum ends in the rows form of its ``Ruleset.spec``, the
spec's axes reduce-scattered, the other data axes all-reduced, with the
per-element sums of ``build_sync``'s trees.

The modes, as in the JAX package:

* ``flat``          — one all-reduce over every replica (reduce-scatter and
                      all-gather over all sync axes: the ring's schedule, the
                      endpoint algorithm FRED's baseline runs).
* ``hierarchical``  — FRED's L1/L2 reduction-distribution tree: reduce-scatter
                      inside the pod, all-reduce across pods on the scattered
                      shard, all-gather inside the pod.
* ``compressed``    — hierarchical with the cross-pod phase carried as int8
                      with error feedback: all-gather of q and scales across
                      pods, dequantize-and-sum.

Every rounding point of the JAX functions is kept: the reduce-scatter result
is in the leaf's dtype, ``carry = shard + error`` in fp32, the dequantized sum
cast to the leaf's dtype, ``/ n_total`` taken in the leaf's dtype.  So are its
quirks: padding per leaf, replica order outer-major, and in compressed mode
without an outer axis the ``(R, 0)`` error placeholder.  The sums differ from
XLA's ``psum_scatter`` in order only: the tree kernel accumulates in fp32 with
a fixed pairwise tree.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..kernels import ops
from ..launch.mesh import DistMesh
from .compress import dequantize, ef_quantize
from .sharding import _names

MODES = ("flat", "hierarchical", "compressed")


def _pad_to(x: torch.Tensor, mult: int) -> Tuple[torch.Tensor, int]:
    """Zeros appended to the last (flat) dimension up to a multiple of
    ``mult``; returns (x, pad)."""
    pad = (-x.shape[-1]) % mult
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x, pad


def flat_all_reduce(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum over every replica of ``axes``: reduce-scatter, then all-gather.
    x: the local flat values (``mesh.local``)."""
    xp, pad = _pad_to(x, mesh.size(axes))
    shard = ops.reduce_shards(mesh.exchange(xp, axes))
    full = mesh.gather(shard, axes).flatten(-2)
    return full[..., :x.shape[-1]] if pad else full


def hierarchical_all_reduce(x: torch.Tensor, mesh, inner_axis: str,
                            outer_axis: Optional[str]) -> torch.Tensor:
    """reduce_scatter(inner) → all_reduce(outer) → all_gather(inner)."""
    xp, pad = _pad_to(x, mesh.shape[inner_axis])
    shard = ops.reduce_shards(mesh.exchange(xp, (inner_axis,)))
    if outer_axis is not None:
        shard = ops.reduce_shards(mesh.gather(shard, (outer_axis,)))
    full = mesh.gather(shard, (inner_axis,)).flatten(-2)
    return full[..., :x.shape[-1]] if pad else full


def compressed_all_reduce(x: torch.Tensor, error: torch.Tensor, mesh,
                          inner_axis: str, outer_axis: Optional[str]):
    """Hierarchical all-reduce with an int8 EF-compressed cross-pod phase.

    Returns (result, new_error).  The inner reduce-scatter stays full
    precision; only the scattered shard that crosses pods is quantized, with
    error feedback so the bias is corrected on the next step.
    """
    xp, pad = _pad_to(x, mesh.shape[inner_axis])
    shard = ops.reduce_shards(mesh.exchange(xp, (inner_axis,)))
    new_error = torch.zeros_like(shard[..., :0])   # placeholder when no outer axis
    if outer_axis is not None:
        carry = shard + error
        q, scale, new_error = ef_quantize(carry)
        # int8 cannot be summed on the wire without overflow: gather the
        # compressed payload, then dequantize and sum
        qs = mesh.gather(q, (outer_axis,))
        ss = mesh.gather(scale, (outer_axis,))
        shard = ops.reduce_shards(dequantize(qs, ss)).to(x.dtype)
    full = mesh.gather(shard, (inner_axis,)).flatten(-2)
    out = full[..., :x.shape[-1]] if pad else full
    return out, new_error


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable[[List[Any]], Any]]:
    """Leaves of a tree of dicts and lists, and the function that rebuilds a
    tree of the same structure from a list of new leaves (module-level walks:
    a closure that calls itself is a reference cycle, and would keep the
    leaves alive until the garbage collector runs)."""
    leaves: List[torch.Tensor] = []
    skeleton = _skeleton(tree, leaves)
    return leaves, lambda new: _rebuild(new, skeleton)


def _skeleton(t, leaves: List[torch.Tensor]):
    if isinstance(t, dict):
        return {k: _skeleton(v, leaves) for k, v in t.items()}
    if isinstance(t, list):
        return [_skeleton(v, leaves) for v in t]
    leaves.append(t)
    return len(leaves) - 1


def _rebuild(new: List[Any], t):
    if isinstance(t, dict):
        return {k: _rebuild(new, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_rebuild(new, v) for v in t]
    return new[t]


def build_sync(mesh, mode: str = "hierarchical", inner_axis: str = "data",
               outer_axis: Optional[str] = None):
    """Gradient synchroniser over *replica-stacked* local gradients.

    Input leaves carry a leading replica dimension: on a stacked mesh of size
    |outer_axis|·|inner_axis| (replica index outer-major), on a distributed
    mesh of size 1 (this rank's block).  The output drops that dimension and
    is the global mean, in each leaf's dtype.  ``mode='compressed'`` returns
    ``sync(grads, errors) -> (mean, new_errors)``, error-feedback leaves
    shaped ``(rows, ceil(size / |inner_axis|))`` fp32 (``init_error_feedback``).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    axes = tuple(a for a in (outer_axis, inner_axis) if a)
    n_total = mesh.size(axes)

    def finish(out, g):
        return (mesh.replicated(out) / n_total).reshape(g.shape[1:]).to(g.dtype)

    def sync_leaf(g):
        flat = mesh.local(g, axes)
        if mode == "flat":
            out = flat_all_reduce(flat, mesh, axes)
        else:
            out = hierarchical_all_reduce(flat, mesh, inner_axis, outer_axis)
        return finish(out, g)

    if mode == "compressed":
        def sync(grads, errors):
            g_flat, rebuild = _flatten(grads)
            e_flat, _ = _flatten(errors)
            if len(e_flat) != len(g_flat):
                raise ValueError(f"{len(g_flat)} gradient leaves, {len(e_flat)} error leaves")
            outs, errs = [], []
            for g, e in zip(g_flat, e_flat):
                out, new_err = compressed_all_reduce(
                    mesh.local(g, axes), mesh.local(e, axes), mesh, inner_axis, outer_axis)
                outs.append(finish(out, g))
                errs.append(mesh.stacked(new_err, axes))
            return rebuild(outs), rebuild(errs)
        return sync

    def sync(grads):
        g_flat, rebuild = _flatten(grads)
        return rebuild([sync_leaf(g) for g in g_flat])
    return sync


def _reduce_stage(x: torch.Tensor, mesh, whole: List[str], axes: Tuple[str, ...]):
    """One stage of ``build_shard_sync`` over ``axes`` (mesh order).  x: the
    local form (``mesh.local``), its flat values laid out as one dimension
    per axis of ``whole`` (the spec axes still whole, in the spec's order),
    then the shard.  The stage's axes that are in ``whole`` are
    reduce-scattered: chunk j of the exchange is the block of the rank of
    group index j (repeated along the stage's other axes, so that every sum
    runs over the whole group in group order, as ``flat_all_reduce``'s
    does); a stage with none of them is an all-reduce on the block.
    Returns (x, ``whole`` without the scattered axes)."""
    scat = [a for a in axes if a in whole]
    if not scat:
        return ops.reduce_shards(mesh.gather(x, axes)), whole
    nl = x.dim() - 1
    y = x.reshape(*x.shape[:nl], *(mesh.shape[a] for a in whole), -1)
    rest = [nl + i for i, a in enumerate(whole) if a not in scat]
    y = y.permute(*range(nl), *(nl + whole.index(a) for a in scat), *rest, y.dim() - 1)
    for j, a in enumerate(axes):
        if a not in whole:
            y = y.unsqueeze(nl + j)
    y = y.expand(*y.shape[:nl], *(mesh.shape[a] for a in axes), *y.shape[nl + len(axes):])
    got = mesh.exchange(y.reshape(*y.shape[:nl], -1), axes)
    return ops.reduce_shards(got), [a for a in whole if a not in scat]


def build_shard_sync(mesh, mode: str = "hierarchical", inner_axis: str = "data",
                     outer_axis: Optional[str] = None):
    """Gradient synchroniser for FSDP: ``sync(g, spec) -> rows``.  g: one
    leaf's gradients with a leading replica dimension (as ``build_sync``
    takes them), each replica's whole gradient as every block of ``spec``
    (``parallel.sharding.all_blocks``): ``(replicas, R, ...)``.  Returns the
    global mean in the rows form over ``spec`` (every rank's block on a
    ``StackedMesh``, this rank's on a ``DistMesh``), in the leaf's dtype.

    ``flat`` reduces over every data axis in one stage, ``hierarchical`` the
    inner axis first, then ``outer_axis``; a stage reduce-scatters the spec's
    axes among its own and all-reduces the rest (``_reduce_stage``).  Every
    element's sum is the one ``build_sync`` of the same mode takes (the same
    tree over the same ranks, the same roundings), so the rows equal the
    shards of its result bit for bit.  A spec axis that is no data axis must
    have one rank."""
    if mode not in ("flat", "hierarchical"):
        raise ValueError(f"build_shard_sync runs 'flat' and 'hierarchical', got {mode!r}")
    axes = tuple(a for a in (outer_axis, inner_axis) if a)
    if mode == "flat":
        stages = [mesh._sorted(axes)]
    else:
        stages = [(a,) for a in (inner_axis, outer_axis) if a]
    n_total = mesh.size(axes)

    def sync(g: torch.Tensor, spec) -> torch.Tensor:
        spec_axes = [a for e in spec for a in _names(e)]
        lone = [a for a in spec_axes if a not in axes and mesh.shape[a] > 1]
        if lone:
            raise ValueError(f"spec {tuple(spec)}: axes {lone} of more than one rank "
                             f"are not data axes of the sync {axes}")
        shard = g.shape[2:]
        x, whole = mesh.local(g, axes), list(spec_axes)
        for stage in stages:
            x, whole = _reduce_stage(x, mesh, whole, stage)
        if not isinstance(mesh, DistMesh):
            # one copy along the mesh axes the spec leaves out (equal there),
            # then the spec's axes in the spec's order: the rows form
            x = x[tuple(slice(None) if a in spec_axes else slice(0, 1)
                        for a in mesh.axis_names)]
            in_mesh = [a for a in mesh.axis_names if a in spec_axes]
            x = x.reshape(*(mesh.shape[a] for a in in_mesh), -1)
            x = x.permute(*(in_mesh.index(a) for a in spec_axes), len(in_mesh))
        return (x.reshape(-1, *shard) / n_total).to(g.dtype)
    return sync


def init_error_feedback(grads_shapes, mesh, inner_axis: str = "data",
                        outer_axis: Optional[str] = "pod"):
    """Zero EF buffers matching the compressed cross-pod shards, fp32: one row
    per replica on a stacked mesh, this rank's row on a distributed one.
    ``grads_shapes`` is a tree of per-replica shapes (tensors or sizes)."""
    axes = tuple(a for a in (outer_axis, inner_axis) if a)
    n = mesh.shape[inner_axis]
    leaves, rebuild = _flatten(grads_shapes)

    def leaf(s):
        size = math.prod(s.shape if hasattr(s, "shape") else s)
        return torch.zeros((mesh.rows(axes), -(-size // n)), dtype=torch.float32,
                           device=mesh.device)
    return rebuild([leaf(s) for s in leaves])
