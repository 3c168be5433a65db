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
from .compress import dequantize, ef_quantize

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
