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
* ``gather_parts(parts)``: several tensors' blocks by one all-gather (one
  all-reduce backward): the attention of heads that do not divide the degree
  gathers its query, key and value columns so (``models.layers``).
* ``flash_decode``: single-token attention over a cache whose *sequence* is
  split over the ranks of one or more axes, the flash-decoding combine as
  GSPMD emits it for ``kv_cache_spec``'s layout: the per-head max of the
  ranks' scores (an exact all-gather and ``amax``), the sum of their
  ``exp(s - m)`` (one all-reduce), the sum of their ``(p / denom) @ V_r`` in
  the cache dtype (one all-reduce).  ``KVSeqContext`` binds it to the
  layout.

Every sum over the ranks is ``collectives.flat_all_reduce`` over the axis:
``mesh.exchange``, ``ops.reduce_shards`` (on the card the tree-reduce kernel
``csrc/reduce_tree.cu``; it raises rather than fall back), ``mesh.gather``.
Each rank's partial is in its own dtype when it is summed (in fp32, by the
kernel's fixed tree), so a TP result is rounded otherwise than the one-device
one: not bit-equal to it.

``TPContext`` binds the operators to a mesh and an axis; the model functions
(``models.layers``, ``models.ssm``, ``models.transformer``, ``models.whisper``)
take one as ``tp=`` and run each rank's heads (attention or SSM), MLP columns,
experts (or their ``mlp`` blocks) and vocab block in turn.  Query heads that
do not divide the degree are padded as ``act_spec("q_heads")`` pads them
(``TPContext.head_ranges``: ceil(H / tp) a rank, the last ranks fewer or
none), KV heads that do not divide are gathered whole.

``KVSeqContext`` is the flash-decoding layout of the decode caches (what
``models.transformer``'s ``prefill`` / ``decode_step`` take as ``kv_seq=``):
the cache's sequence in blocks over the ranks of its axes, every KV head on
every rank, the storage padded to a multiple of the ranks.

``EPContext`` binds expert parallelism inside the setups to a mesh and its
EP axis (a data axis): ``models.transformer``'s functions take one as
``ep=`` and run the lanes of an EP group (the ranks of the axis, each with
its own sequences) together through every MoE block
(``models.moe.moe_ffn_lanes``, whose all-to-all is ``launch.mesh``'s).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import torch

from ..launch.mesh import DistMesh, at_turns, count_turns
from ..models.attention import decode_scores, decode_valid, decode_values
from ..models.modules import NEG_BIG, _CE_CHUNK_ELEMENTS
from .collectives import flat_all_reduce
from .sharding import shard_leaf, unshard_leaf


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for bf16 / fp16 / fp32 (as the one-device cross-entropy), float64
    for float64 (a gradient check)."""
    return torch.promote_types(dtype, torch.float32)


def _axes(axis) -> Tuple[str, ...]:
    """One axis name or a sequence of them, as a tuple (the rows form over
    several axes is row-major over them in that order)."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def all_reduce_rows(rows: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The sum over the ranks of ``axis`` (a name or a tuple of names) of a
    tensor in the rows form ``(R, ...)``: ``(...)``, the same on every rank.
    One tree-reduce launch (``flat_all_reduce``)."""
    axes = _axes(axis)
    shape = rows.shape[1:]
    flat = mesh.local(rows.reshape(rows.shape[0], -1), axes)
    return mesh.replicated(flat_all_reduce(flat, mesh, axes)).reshape(shape)


def _max_rows(rows: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The elementwise max over the ranks of ``axis`` (a name or a tuple) of
    ``(R, n)`` rows: an all-gather and ``amax``, exact (as
    ``parallel.steps._row_max_fn``)."""
    axes = _axes(axis)
    got = mesh.gather(mesh.local(rows, axes), axes)
    return mesh.replicated(got.amax(dim=-2))


class _CopyToTP(torch.autograd.Function):
    """f: identity forward (the whole tensor as every row), all-reduce of the
    rows' gradients backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.turns = mesh, axis, count_turns()
        return x.unsqueeze(0).expand(mesh.rows((axis,)), *x.shape)

    @staticmethod
    def backward(ctx, g):
        with at_turns(ctx.turns):
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
        ctx.mesh, ctx.axis, ctx.turns = mesh, axis, count_turns()
        whole = unshard_leaf(rows, _last_dim_spec(rows.dim() - 1, axis), mesh)
        return whole.unsqueeze(0).expand(rows.shape[0], *whole.shape)

    @staticmethod
    def backward(ctx, g):
        with at_turns(ctx.turns):
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


def gather_parts(parts: Sequence[torch.Tensor], mesh, axis: str) -> List[torch.Tensor]:
    """Several tensors in the rows form ``(R, *shape_i, c_i)``, each rank's
    block of each one's last dimension, put together by one gather
    (``gather_from_tp`` of their flattened concatenation; backward one
    all-reduce).  Returns for each part ``(R, size, *shape_i, c_i)``: every
    rank's block, views of one copy; ``whole_row`` gives a row's whole
    tensor ``(*shape_i, size * c_i)``."""
    R = parts[0].shape[0]
    flat = [p.reshape(R, -1) for p in parts]
    got = gather_from_tp(torch.cat(flat, dim=-1), mesh, axis)
    size = mesh.shape[axis]
    got = got.reshape(R, size, -1)
    out, start = [], 0
    for p, f in zip(parts, flat):
        n = f.shape[1]
        out.append(got[:, :, start:start + n].reshape(R, size, *p.shape[1:]))
        start += n
    return out


def whole_row(part: torch.Tensor) -> torch.Tensor:
    """One row of ``gather_parts``'s result, ``(size, *shape, c)`` → the
    whole tensor ``(*shape, size * c)``."""
    return part.movedim(0, -2).reshape(*part.shape[1:-1], -1)


def flash_decode(q: torch.Tensor, k_blocks, v_blocks, valid_blocks, mesh, axis,
                 scale=None) -> torch.Tensor:
    """``models.attention.decode_attention`` of the single query ``q`` (B, 1,
    Hq, hd) over a cache whose sequence lies in blocks on the ranks of
    ``axis`` (a name or a tuple of names): ``k_blocks`` / ``v_blocks`` /
    ``valid_blocks`` one entry per row of the rows form over ``axis`` (each
    (B, n, Hkv, hd), and (B|1, n) bool).  Three sums over the ranks, in this
    order on every rank: the per-head max of their scores (an all-gather and
    ``amax``, exact), the denominators ``sum exp(s - m)`` (one all-reduce),
    each rank's ``((p / denom) in the cache dtype) @ V_r`` (one all-reduce).
    So the roundings are ``decode_attention``'s (normalise, cast, product)
    and only the order of the sums differs.  A block with no valid slot has
    scores of ``NEG_INF`` and adds exactly 0.  Returns (B, 1, Hq, hd) in
    ``q.dtype``, the same on every rank."""
    B, _, Hq, hd = q.shape
    s = [decode_scores(q, k, ok, scale) for k, ok in zip(k_blocks, valid_blocks)]
    stats = s[0].shape[:-1] + (1,)
    m = _max_rows(torch.stack([x.amax(dim=-1).reshape(-1) for x in s]), mesh, axis)
    m = m.reshape(stats)
    p = [torch.exp(x - m) for x in s]
    denom = all_reduce_rows(torch.stack([x.sum(dim=-1, keepdim=True) for x in p]), mesh, axis)
    out = all_reduce_rows(torch.stack([decode_values(x, denom, v)
                                       for x, v in zip(p, v_blocks)]), mesh, axis)
    return out.float().reshape(B, 1, Hq, hd).to(q.dtype)


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

    def padded(self, n: int) -> int:
        """The heads a rank holds of ``n`` padded over the axis (GSPMD's
        padding of ``act_spec("q_heads")``): ceil(n / size)."""
        return -(-n // self.size)

    def head_ranges(self, n: int) -> List[Tuple[int, int]]:
        """Each row's heads ``[start, stop)`` of ``n`` padded over the axis:
        ``padded(n)`` a rank, the last ranks fewer or none (56 over 16: 4 a
        rank, ranks 14-15 none; 20 over 8: 3 a rank, rank 6 two, rank 7
        none)."""
        hp = self.padded(n)
        return [(min(c * hp, n), min((c + 1) * hp, n)) for c in self.coords]

    def gather_parts(self, parts) -> List[torch.Tensor]:
        return gather_parts(parts, self.mesh, self.axis)

    @staticmethod
    def whole_row(part: torch.Tensor) -> torch.Tensor:
        return whole_row(part)

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


@dataclasses.dataclass(frozen=True)
class KVSeqContext:
    """The flash-decoding layout of the decode caches: what
    ``Ruleset.kv_cache_spec`` gives where it puts the cache's sequence on
    ``axes`` (KV heads that do not divide the TP degree, or a batch that no
    data axis divides).  ``length`` is the logical cache length (a sliding
    window's rolling buffer, ``min(cache_len, window)``); the storage pads it
    to ``size * block`` slots, as GSPMD pads a ragged dimension, and a padded
    slot is never valid.  A cache in this layout is ``(B, rows * block, Hkv,
    hd)``: every rank's block in order on a ``StackedMesh`` (the whole padded
    cache), this rank's on a ``DistMesh``; every KV head."""
    mesh: Any
    axes: Tuple[str, ...]
    length: int

    @property
    def size(self) -> int:
        return self.mesh.size(self.axes)

    @property
    def rows(self) -> int:
        return self.mesh.rows(self.axes)

    @property
    def block(self) -> int:
        return -(-self.length // self.size)

    @property
    def starts(self) -> List[int]:
        """The first slot of each row's block."""
        if isinstance(self.mesh, DistMesh):
            return [self.mesh.replica(self.axes) * self.block]
        return [i * self.block for i in range(self.size)]

    def place(self, cache: torch.Tensor) -> torch.Tensor:
        """A whole cache ``(B, length, H, hd)`` → this layout."""
        pad = self.size * self.block - cache.shape[1]
        if pad:
            cache = torch.nn.functional.pad(cache, (0, 0, 0, 0, 0, pad))
        if isinstance(self.mesh, DistMesh):
            return cache.narrow(1, self.starts[0], self.block)
        return cache

    def write(self, buf: torch.Tensor, kv: torch.Tensor, pos: int) -> None:
        """Write ``kv`` (B, 1, H, hd) at logical slot ``pos`` into ``buf``
        in place: the rank whose block holds the slot writes it."""
        for i, start in enumerate(self.starts):
            if start <= pos < start + self.block:
                buf[:, i * self.block + pos - start] = kv[:, 0].to(buf.dtype)

    def attend(self, q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor, valid: int,
               window: int = 0) -> torch.Tensor:
        """``decode_attention(q, k, v, valid, window=window)`` of the whole
        cache, from each rank's block (``flash_decode``): slot j is valid
        where ``j < valid`` (and ``j >= valid - window``)."""
        n = self.block
        ks = [k_buf.narrow(1, i * n, n) for i in range(self.rows)]
        vs = [v_buf.narrow(1, i * n, n) for i in range(self.rows)]
        oks = [decode_valid(start + torch.arange(n, device=q.device), valid, window)
               for start in self.starts]
        return flash_decode(q, ks, vs, oks, self.mesh, self.axes)
