"""Pipeline parallelism: the GPipe schedule over a ``pipe`` mesh axis.

Counterpart of ``repro.parallel.pipeline``.  FRED's pipeline pattern (Sec.
II-C), boundary activations forwarded stage to stage, is a cyclic shift along
the ``pipe`` axis (``launch.mesh.ppermute``).  Each stage holds its slice of
the stage parameters; over M + S − 1 ticks, stage 0 takes in microbatch t,
every stage applies ``stage_fn`` to what it holds, the outputs shift one
stage on, and the last stage's outputs are the result.  The bubble, the
schedule and the transfers are GPipe's.  The backward runs through the same
ticks in reverse (each shift's backward shifts back), so one ``backward`` of
a loss of the result trains through the pipeline.

The stage parameters are the stacked ones (every leaf (S, ...), stage s at
index s, as ``sequential_reference`` takes them) placed over the pipe axis by
``parallel.sharding.shard_leaf(t, (pipe,), mesh)``: every leaf (S, 1, ...) on
a ``StackedMesh`` (every stage on one device, a view) and (1, 1, ...) on a
``DistMesh`` (this rank's stage), the rows form of ``launch.mesh``.  On the
stacked transport a tick runs the stages one after another on one device; a
stage with no microbatch in a tick (the bubble) passes zeros and computes
nothing.

On a ``DistMesh`` only the last stage holds the result; every other stage
holds zeros, which carry no gradient to any stage.  Each tick's data flow is
the same on every rank (a stage out of the schedule passes zeros through the
same selections), so that every rank runs every shift's backward, in the same
order: take the loss on every rank, weighted by whether the rank is the last
stage (gradients are those of the sum of the ranks' losses), and call
``backward`` on every rank.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..launch.mesh import ppermute
from ..models.modules import tree_flatten, tree_map


def _pick(cond: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` if ``cond`` else ``b``, with both in the autograd graph."""
    return torch.where(torch.tensor(cond, device=a.device), a, b)


def pipeline_fn(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], n_stages: int,
                n_microbatches: int, mesh, pipe_axis: str = "pipe"):
    """A pipelined apply ``(stage_params, x_mb) -> y_mb``.

    ``stage_fn(params, x) -> y`` is one stage on one microbatch; y has x's
    shape and dtype.  ``stage_params``: a tree of leaves placed by
    ``shard_leaf(t, (pipe_axis,), mesh)``, (R, 1, ...) with R =
    ``mesh.rows((pipe_axis,))`` (S, or 1 on a ``DistMesh``).  ``x_mb``: (M,
    ...), the microbatches, the same on every rank.  Returns (M, ...), the
    last stage's output of each microbatch."""
    S, M = n_stages, n_microbatches
    if mesh.shape.get(pipe_axis) != S:
        raise ValueError(f"pipeline_fn: {S} stages need a {pipe_axis!r} axis of size {S}, "
                         f"the mesh has {mesh.shape}")
    stages = mesh.row_coords(pipe_axis)
    R = len(stages)
    # the row whose outputs are returned: the last stage's (stacked), the
    # rank's own (distributed)
    out_row = stages.index(S - 1) if S - 1 in stages else 0

    def apply(stage_params, x_mb: torch.Tensor) -> torch.Tensor:
        leaves, _ = tree_flatten(stage_params)
        if any(t.shape[:2] != (R, 1) for t in leaves):
            raise ValueError(f"pipeline_fn: every stage parameter needs the leading "
                             f"dimensions ({R}, 1) of shard_leaf over {pipe_axis!r}, got "
                             f"{[tuple(t.shape) for t in leaves]}")
        if x_mb.shape[0] != M:
            raise ValueError(f"pipeline_fn: {M} microbatches, x_mb {tuple(x_mb.shape)}")
        local = [tree_map(lambda t, r=r: t[r, 0], stage_params) for r in range(R)]
        # zeros in the graph whenever a gradient is taken: then every shift's
        # input needs one on every rank, from the first tick on, whichever
        # stages that tick runs
        zeros = x_mb.new_zeros(x_mb.shape[1:]).requires_grad_(
            torch.is_grad_enabled() and any(t.requires_grad for t in leaves + [x_mb]))
        buf = [zeros] * R
        outs = []
        for t in range(M + S - 1):
            mb = x_mb[min(t, M - 1)]
            ys = []
            for r, s in enumerate(stages):
                inp = _pick(s == 0, mb, buf[r])
                y = stage_fn(local[r], inp) if 0 <= t - s < M else _pick(False, inp, zeros)
                ys.append(y)
                if r == out_row and t >= S - 1:
                    outs.append(_pick(s == S - 1, y, zeros))
            if t < M + S - 2:                 # the last tick's shift goes nowhere
                buf = list(ppermute(mesh, torch.stack(ys), pipe_axis, 1).unbind(0))
        return torch.stack(outs)

    return apply


def stack_stages(blocks, n_stages: int):
    """Per-layer parameter trees (a list of L dictionaries, as
    ``transformer.init`` gives ``blocks``) as stacked stage parameters: a list
    of L/S trees, entry j with leaves (S, ...) holding block s·L/S + j at
    index s (stage s runs blocks s·L/S ... (s + 1)·L/S - 1 in order)."""
    L = len(blocks)
    if L % n_stages:
        raise ValueError(f"{L} blocks do not split into {n_stages} stages")
    per = L // n_stages

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)
    return [stack([blocks[s * per + j] for s in range(n_stages)]) for j in range(per)]


def sequential_reference(stage_fn, stage_params, x_mb: torch.Tensor,
                         n_stages: int) -> torch.Tensor:
    """Oracle: every microbatch through the stages one after another.
    ``stage_params`` leaves have the leading dimension ``n_stages``."""
    out = []
    for x in x_mb.unbind(0):
        for s in range(n_stages):
            x = stage_fn(tree_map(lambda t: t[s], stage_params), x)
        out.append(x)
    return torch.stack(out)
