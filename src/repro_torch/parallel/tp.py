"""Tensor parallelism over a mesh axis (Megatron's column / row split).

The JAX package gets tensor parallelism from its placements: ``Ruleset``
puts ``vocab`` / ``qkv`` / ``kv`` / ``mlp`` on the TP axis (``model``) and
XLA inserts the collectives.  The port writes them out.  A rank of a TP group
holds its block of every leaf the spec shards over the axis (its query and KV
heads' columns of ``wq`` / ``wk`` / ``wv``, its rows of ``wo``, its columns
of ``w_gate`` / ``w_up`` and rows of ``w_down``, its vocab rows of the
embedding and its columns of an untied head); the residual stream is whole on
every rank.

Every operator takes and gives the *rows* form of ``launch.mesh`` over the TP
axis: a leading dimension of ``mesh.rows((axis,))``, every rank's block on a
``StackedMesh`` (the ranks run in turn on one device), this rank's on a
``DistMesh``.  The same code serves both meshes:

* ``copy_to_tp(x)`` (Megatron's f): a whole tensor → the rows form, each row
  ``x``; its backward all-reduces the rows' gradients, so that the gradient
  of a tensor every rank reads is summed by the same reduction on both
  meshes (not by autograd's accumulation over the stacked ranks).
* ``reduce_from_tp(parts)`` (Megatron's g): the rows' sum, whole on every
  rank; its backward hands every row the gradient.
* ``vocab_parallel_embed``: each rank looks up the tokens of its vocab range
  (zeros elsewhere), then g.
* ``vocab_parallel_cross_entropy``: the mean token cross-entropy of logits
  whose vocab is split over the ranks, with its gradient written by hand.
* ``gather_from_tp(rows)``: each rank's block of the last dimension → the
  whole tensor as every row (an all-gather); its backward sums the rows'
  gradients (one all-reduce) and hands each rank its block, a
  reduce-scatter.  The Mamba2 mixer gathers its fused in-projection and its
  conv output so (``models.ssm.mamba2_forward(tp=)``).
* ``gather_logits``: a rank's ``(..., V / tp)`` logits → whole ``(..., V)``
  (forward only, for serving).

Every sum over the ranks is ``collectives.flat_all_reduce`` over the axis:
``mesh.exchange``, ``ops.reduce_shards`` (on the card the tree-reduce kernel
``csrc/reduce_tree.cu``; it raises rather than fall back), ``mesh.gather``.
Each rank's partial is in its own dtype when it is summed (in fp32, by the
kernel's fixed tree), so a TP result is rounded otherwise than the one-device
one: not bit-equal to it.

``TPContext`` binds the operators to a mesh and an axis; the model functions
(``models.layers``, ``models.ssm``, ``models.transformer``, ``models.whisper``)
take one as ``tp=`` and run each rank's heads (attention or SSM), MLP columns,
experts (or their ``mlp`` blocks) and vocab block in turn.

``EPContext`` binds expert parallelism inside the setups to a mesh and its
EP axis (a data axis): ``models.transformer``'s functions take one as
``ep=`` and run the lanes of an EP group (the ranks of the axis, each with
its own sequences) together through every MoE block
(``models.moe.moe_ffn_lanes``, whose all-to-all is ``launch.mesh``'s).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.modules import NEG_BIG, _CE_CHUNK_ELEMENTS
from .collectives import flat_all_reduce
from .sharding import shard_leaf, unshard_leaf


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for bf16 / fp16 / fp32 (as the one-device cross-entropy), float64
    for float64 (a gradient check)."""
    return torch.promote_types(dtype, torch.float32)


def all_reduce_rows(rows: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over the ranks of ``axis`` of a tensor in the rows form
    ``(R, ...)``: ``(...)``, the same on every rank.  One tree-reduce launch
    (``flat_all_reduce``)."""
    shape = rows.shape[1:]
    flat = mesh.local(rows.reshape(rows.shape[0], -1), (axis,))
    return mesh.replicated(flat_all_reduce(flat, mesh, (axis,))).reshape(shape)


def _max_rows(rows: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise max over the ranks of ``axis`` of ``(R, n)`` rows: an
    all-gather and ``amax``, exact (as ``parallel.steps._row_max_fn``)."""
    got = mesh.gather(mesh.local(rows, (axis,)), (axis,))
    return mesh.replicated(got.amax(dim=-2))


class _CopyToTP(torch.autograd.Function):
    """f: identity forward (the whole tensor as every row), all-reduce of the
    rows' gradients backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.unsqueeze(0).expand(mesh.rows((axis,)), *x.shape)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_rows(g, ctx.mesh, ctx.axis), None, None


class _ReduceFromTP(torch.autograd.Function):
    """g: all-reduce forward, identity backward (every row the gradient)."""

    @staticmethod
    def forward(ctx, parts, mesh, axis):
        ctx.rows = parts.shape[0]
        return all_reduce_rows(parts, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(0).expand(ctx.rows, *g.shape), None, None


def _last_dim_spec(ndim: int, axis: str):
    """The spec of a tensor of ``ndim`` dims whose last one is split over
    ``axis``."""
    return (None,) * (ndim - 1) + (axis,)


class _GatherFromTP(torch.autograd.Function):
    """All-gather of the last dimension: forward every rank's block → the
    whole tensor as every row; backward the rows' gradients summed by one
    all-reduce, each rank its block of the sum (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, rows, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        whole = unshard_leaf(rows, _last_dim_spec(rows.dim() - 1, axis), mesh)
        return whole.unsqueeze(0).expand(rows.shape[0], *whole.shape)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce_rows(g, ctx.mesh, ctx.axis)
        return shard_leaf(total, _last_dim_spec(total.dim(), ctx.axis), ctx.mesh), None, None


def gather_from_tp(rows: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``rows`` (R, ..., n / tp), each rank's block of the last dimension in
    the rows form → (R, ..., n), every row the whole tensor (a view of one
    copy); the gradient of a rank's block is its block of the sum of the
    rows' gradients (on the card one tree-reduce launch)."""
    if rows.shape[0] != mesh.rows((axis,)):
        raise ValueError(f"gather_from_tp: need the rows form over {axis!r}, a leading "
                         f"dimension of {mesh.rows((axis,))}, got {tuple(rows.shape)}")
    return _GatherFromTP.apply(rows, mesh, axis)


def copy_to_tp(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's f: ``x`` (whole, the same on every rank) → ``(R, *x.shape)``,
    each row ``x`` (a view); the gradient of ``x`` is the sum of the rows'."""
    return _CopyToTP.apply(x, mesh, axis)


def reduce_from_tp(parts: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's g: ``parts`` (R, ...) in the rows form → their sum over the
    ranks, whole on every rank; the gradient of every row is the sum's."""
    if parts.shape[0] != mesh.rows((axis,)):
        raise ValueError(f"reduce_from_tp: need the rows form over {axis!r}, a leading "
                         f"dimension of {mesh.rows((axis,))}, got {tuple(parts.shape)}")
    return _ReduceFromTP.apply(parts, mesh, axis)


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor, mesh,
                         axis: str) -> torch.Tensor:
    """The embedding of ``tokens`` (any shape, ids into the whole vocab) from
    ``table`` in the rows form ``(R, V / tp, d)``: each rank gathers the rows
    of the tokens in its vocab range and zeros for the others, then g sums
    the ranks.  The backward of a rank's lookup adds the gradient into its
    own rows only (autograd's index backward, as the one-device lookup's)."""
    block = table.shape[1]
    parts = []
    for r, c in enumerate(mesh.row_coords(axis)):
        local = tokens - c * block
        inside = (local >= 0) & (local < block)
        rows = table[r][local.clamp(0, block - 1)]
        parts.append(torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                      device=rows.device)))
    return reduce_from_tp(torch.stack(parts), mesh, axis)


class _VocabParallelCE(torch.autograd.Function):
    """The mean token cross-entropy of ``(R, ..., V / tp)`` logits in the
    rows form, chunk by chunk of rows as ``models.modules._CrossEntropy``:
    the row max over the ranks (an all-gather), then the sum of exps against
    it and the target logit, both summed over the ranks by one all-reduce;
    a rank's columns past ``vocab_size`` (the padded vocab's tail) are out of
    the sum.  The backward needs no communication: every rank writes the
    gradient of its columns from the row's log-sum-exp."""

    @staticmethod
    def forward(ctx, logits, labels, vocab_size: int, z_weight: float, mesh, axis: str):
        R, block = logits.shape[0], logits.shape[-1]
        flat = logits.reshape(R, -1, block)
        n = flat.shape[1]
        lab = labels.reshape(-1).long()
        acc = _acc_dtype(logits.dtype)
        coords = mesh.row_coords(axis)
        step = max(1, _CE_CHUNK_ELEMENTS // block)
        valid = [min(max(vocab_size - c * block, 0), block) for c in coords]

        def chunk(r, r0):
            x = flat[r, r0:r0 + step].to(acc, copy=True)     # never the caller's logits
            if valid[r] < block:
                x[:, valid[r]:] = NEG_BIG
            return x

        row_max = torch.empty((R, n), dtype=acc, device=logits.device)
        for r in range(R):
            for r0 in range(0, n, step):
                row_max[r, r0:r0 + step] = chunk(r, r0).amax(dim=-1)
        m = _max_rows(row_max, mesh, axis)
        del row_max
        part = torch.zeros((R, 2, n), dtype=acc, device=logits.device)
        for r, c in enumerate(coords):
            for r0 in range(0, n, step):
                x = chunk(r, r0)
                part[r, 0, r0:r0 + step] = torch.exp(x - m[r0:r0 + step, None]).sum(dim=-1)
            local = lab - c * block
            inside = (local >= 0) & (local < block)
            picked = flat[r].gather(1, local.clamp(0, block - 1)[:, None])[:, 0].to(acc)
            part[r, 1] = torch.where(inside, picked, torch.zeros((), dtype=acc,
                                                                 device=picked.device))
        tot = all_reduce_rows(part, mesh, axis)
        lse = m + torch.log(tot[0])
        nll = lse - tot[1]
        if z_weight:
            nll = nll + z_weight * lse.square()
        mask = (lab >= 0).to(acc)
        count = mask.sum().clamp_min(1.0)
        ctx.save_for_backward(logits, lab, lse, count)
        ctx.vocab_size, ctx.z_weight, ctx.mesh, ctx.axis = vocab_size, z_weight, mesh, axis
        ctx.mark_non_differentiable(count)
        return (nll * mask).sum() / count, count

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_loss, _g_count):
        logits, lab, lse, count = ctx.saved_tensors
        R, block = logits.shape[0], logits.shape[-1]
        flat = logits.reshape(R, -1, block)
        grad = torch.empty_like(flat)
        acc = lse.dtype
        step = max(1, _CE_CHUNK_ELEMENTS // block)
        w = g_loss.to(acc) * (lab >= 0).to(acc) / count
        for r, c in enumerate(ctx.mesh.row_coords(ctx.axis)):
            valid = min(max(ctx.vocab_size - c * block, 0), block)
            local = lab - c * block
            inside = (local >= 0) & (local < block)
            for r0 in range(0, flat.shape[1], step):
                x = flat[r, r0:r0 + step].to(acc, copy=True)
                if valid < block:
                    x[:, valid:] = NEG_BIG
                lse_c = lse[r0:r0 + step, None]
                p = torch.exp(x - lse_c)
                if ctx.z_weight:
                    p = p * (1 + 2 * ctx.z_weight * lse_c)
                w_c = w[r0:r0 + step]
                p = p * w_c[:, None]
                hit = inside[r0:r0 + step]
                p.scatter_add_(1, local[r0:r0 + step].clamp(0, block - 1)[:, None],
                               torch.where(hit, -w_c, torch.zeros_like(w_c))[:, None])
                grad[r, r0:r0 + step] = p.to(grad.dtype)
        return grad.view_as(logits), None, None, None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
                                 mesh, axis: str, z_weight: float = 0.0):
    """``models.modules.softmax_cross_entropy`` of logits whose vocab is
    split over the ranks of ``axis``: ``logits`` (R, ..., V / tp) in the
    rows form (rank r's columns ``c * V / tp ...``, c its coordinate),
    ``labels`` (...) ids into the whole vocab, < 0 masked.  Returns
    (mean_loss, token_count), fp32 scalars (float64 for float64 logits),
    the same on every rank."""
    if logits.shape[0] != mesh.rows((axis,)):
        raise ValueError(f"vocab_parallel_cross_entropy: need the rows form over {axis!r}, "
                         f"got {tuple(logits.shape)}")
    return _VocabParallelCE.apply(logits, labels, vocab_size, float(z_weight), mesh, axis)


def gather_logits(rows: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """A rank's ``(R, ..., V / tp)`` logits → the whole ``(..., V)`` (on a
    ``DistMesh`` an all-gather over the axis)."""
    return unshard_leaf(rows, _last_dim_spec(rows.dim() - 1, axis), mesh)


@dataclasses.dataclass(frozen=True)
class TPContext:
    """The TP operators bound to ``mesh`` and its ``axis``: what the model
    functions take as ``tp=``.  ``rows`` is the leading dimension of the rows
    form (the degree on a ``StackedMesh``, 1 on a ``DistMesh``)."""
    mesh: Any
    axis: str

    @property
    def size(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def rows(self) -> int:
        return self.mesh.rows((self.axis,))

    @property
    def coords(self):
        """The coordinate along the axis of each row of the rows form."""
        return self.mesh.row_coords(self.axis)

    def heads(self, n: int) -> int:
        """Of ``n`` heads split over the axis, how many the rows form holds
        (all ``n`` on a ``StackedMesh``, this rank's on a ``DistMesh``)."""
        if n % self.size:
            raise ValueError(f"{n} heads do not divide over {self.size} ranks of {self.axis!r}")
        return n // self.size * self.rows

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_tp(x, self.mesh, self.axis)

    def reduce(self, parts: torch.Tensor) -> torch.Tensor:
        return reduce_from_tp(parts, self.mesh, self.axis)

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        return gather_from_tp(rows, self.mesh, self.axis)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        return vocab_parallel_embed(table, tokens, self.mesh, self.axis)

    def cross_entropy(self, logits, labels, vocab_size: int, z_weight: float = 0.0):
        return vocab_parallel_cross_entropy(logits, labels, vocab_size, self.mesh, self.axis,
                                            z_weight)

    def gather_logits(self, rows: torch.Tensor) -> torch.Tensor:
        return gather_logits(rows, self.mesh, self.axis)


@dataclasses.dataclass(frozen=True)
class EPContext:
    """Expert parallelism over the data axis ``axis`` of ``mesh`` inside the
    setups: what the model functions take as ``ep=``.  ``rows`` is the
    number of lanes a call runs (the axis's size on a ``StackedMesh``, 1 on
    a ``DistMesh``)."""
    mesh: Any
    axis: str

    @property
    def size(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def rows(self) -> int:
        return self.mesh.rows((self.axis,))
