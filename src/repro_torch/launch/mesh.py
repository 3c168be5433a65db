"""Meshes for the gradient synchroniser, and FRED's device placement.

Counterpart of ``repro.launch.mesh``.  A JAX mesh is an array of devices that
``shard_map`` runs one program over.  The port has two meshes, each with its
own transport, and the caller chooses between them; nothing here switches
transport on what it finds:

* ``make_mesh(shape, axes, device=)`` — a ``StackedMesh``: every replica lives
  on one device as a leading dimension of the tensors.  Exchanging or
  gathering shards across an axis is a strided view; each combine is then one
  kernel launch over all replicas at once.
* ``make_dist_mesh(shape, axes)`` — a ``DistMesh``: each replica is a
  ``torch.distributed`` rank, with a process group for every set of axes.
  Exchanging is ``all_to_all_single``, gathering ``all_gather_into_tensor``.

``parallel.collectives`` writes its schedules once over the interface the two
share.  A *local* tensor is what one replica holds, flat: ``(n,)`` on a
``DistMesh``; on a ``StackedMesh`` ``lead + (n,)`` with one leading dimension
per mesh axis (in mesh order), of the axis's size where replicas differ along
it and of size 1 where they are equal (replicated), so broadcasting keeps
replicated values once.  On both, the group index of a rank over a set of axes
is row-major over those axes in mesh order.

``any_rank(mesh, flag)`` is the one agreement the train loop needs (a stop
flag, a failed checkpoint write): an all-reduce over the world on a
``DistMesh``, the flag itself on a ``StackedMesh``.

Besides the sync's steps, both meshes shift a value one way along an axis
(``permute``, the JAX ``ppermute``: a roll of the axis's leading dimension on
the stacked transport, ``batch_isend_irecv`` over the axis's group on the
distributed one), and name the coordinate of each row they hold
(``row_coords``).  The model-parallel layers (``models.moe.moe_ffn_ep``,
``parallel.pipeline``) need gradients through the transport, so three
functions wrap it for autograd.  They take the *rows* form: a tensor whose
leading dimension is ``mesh.rows(axes)`` (every rank's block on the stacked
transport, this rank's alone on the distributed one), which is what
``parallel.sharding.shard_leaf`` gives:

* ``all_to_all(mesh, x, axes)``  — x (R, G, ...), block j for the rank of
  group index j → (R, G, ...), block j what that rank sent; its own inverse,
  so its backward is itself;
* ``ppermute(mesh, x, axis, shift)`` — each rank's x to the rank ``shift``
  further along ``axis`` (cyclic); its backward is the shift back;
* ``pmean(mesh, x, axes)`` — the mean of x over the group, built on
  ``all_to_all`` (counted as the all-reduce it is, ``counted_as``).

On the distributed transport every rank holds its own loss, and a gradient
is that of the sum of the ranks' losses.  Every rank must run each of these
backwards, in the same order (the same program does), or the collectives
pair the wrong messages (their shapes match, so the gradients come out wrong
without a word) or wait for ever.

``count_collectives()`` counts the bytes the collectives move, per device,
the counterpart of the JAX package's ``collective_bytes_from_hlo``: every
collective of the port is one of the three primitives of each mesh, and
each call adds the bytes one rank holds of its output (the dimensions after
the mesh's leading ones, times the element size), the HLO parser's
convention.  ``exchange`` is an ``all-to-all``, ``gather`` an
``all-gather``, ``permute`` a ``collective-permute``.  JAX's kinds map so: its
``reduce-scatter`` (output x group) is the port's exchange leg, byte for
byte; its ``all-reduce`` of n bytes is n as all-to-all plus n as all-gather
here (``parallel.collectives.flat_all_reduce`` builds it from both).
Backwards count as they run, and so do remat's reruns.  A collective over a
group of one rank moves nothing and counts nothing.  A collective that the
stacked transport does as a view (``parallel.sharding.unshard_leaf``, what a
``DistMesh`` does by an all-gather) counts through ``count_stacked``; where a
``StackedMesh`` runs the ranks of a group in turn (``in_turns``), each turn's
calls count as a rank's share of one; a call that runs several turns
together (``jointly``: an EP group's lanes in one exchange) counts their
shares; a call whose payload holds several ranks' blocks (``of_blocks``)
counts one block's bytes.  A backward counts in its forward's turns
(``count_turns`` / ``at_turns`` in the ``autograd.Function`` s).  So a
``StackedMesh`` and a ``DistMesh`` of one shape count the same per device
(``tools/count_parity.py``).  With no count active a primitive pays one
``None`` check.

``fred_device_order`` is the port's own copy of the JAX function (NumPy
only).  ``make_production_mesh`` gives the JAX package's production meshes,
(16, 16) ``(data, model)`` or (2, 16, 16) ``(pod, data, model)``, as a
``StackedMesh`` on the meta device: ``parallel.sharding.Ruleset`` and the
setups' placement metadata read only its axes and sizes, and no tensor is
placed over its 256 or 512 stacked ranks.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.modules import resolve_device


def fred_device_order(n_devices: int, mp: int, dp: int, pp: int) -> np.ndarray:
    """FRED placement: worker (m, d, p) → physical NPU index.

    Workers of the same MP group sit on consecutive devices; MP groups of
    the same PP stage follow; DP replicas iterate outermost (paper Sec. V:
    "map the training workers within the same MP group on consecutive
    physical NPUs followed by iterating over workers within PP and DP").

    Returns an (mp, dp, pp) → device-id array.
    """
    if mp * dp * pp > n_devices:
        raise ValueError(f"mp*dp*pp = {mp * dp * pp} exceeds {n_devices} devices")
    order = np.zeros((mp, dp, pp), dtype=np.int64)
    nid = 0
    for d in range(dp):
        for p in range(pp):
            for m in range(mp):
                order[m, d, p] = nid
                nid += 1
    return order


_counter = None      # the record of the active count_collectives, or None


class _Collectives:
    """Bytes by kind and the number of calls so far; ``turns``: the product
    of the enclosing ``in_turns`` over that of the enclosing ``jointly``;
    ``blocks``: the enclosing ``of_blocks``."""

    def __init__(self):
        self.per_kind: Dict[str, Fraction] = {}
        self.ops = Fraction(0)
        self.turns = Fraction(1)
        self.blocks = 1

    def add(self, kind: str, nbytes: int) -> None:
        share = 1 / self.turns
        self.per_kind[kind] = self.per_kind.get(kind, 0) + nbytes * share / self.blocks
        self.ops += share


def _exact(x: Fraction):
    return int(x) if x.denominator == 1 else float(x)


@contextlib.contextmanager
def count_collectives():
    """Count the collectives of what runs inside; yields a dict that holds
    ``{"per_kind_bytes", "total_bytes", "op_count"}`` per device once the
    block ends (``collective_bytes_from_hlo``'s keys).  One count at a
    time."""
    global _counter
    if _counter is not None:
        raise RuntimeError("count_collectives: a count is already running")
    _counter, rec = _Collectives(), {}
    try:
        yield rec
    finally:
        c, _counter = _counter, None
    rec["per_kind_bytes"] = {k: _exact(v) for k, v in c.per_kind.items()}
    rec["total_bytes"] = _exact(sum(c.per_kind.values(), Fraction(0)))
    rec["op_count"] = _exact(c.ops)


@contextlib.contextmanager
def _turns_times(factor: Fraction):
    c = _counter
    if c is None or factor == 1:
        yield
        return
    c.turns *= factor
    try:
        yield
    finally:
        c.turns /= factor


def in_turns(n: int):
    """The ranks of a group run ``n`` turns on a ``StackedMesh`` (the batch
    rows of a setup, one after another): a call inside counts 1 / n, a
    rank's share (on a ``DistMesh`` each rank runs one turn, n = 1)."""
    return _turns_times(Fraction(n))


def jointly(n: int):
    """A call inside runs ``n`` of the enclosing turns together (the lanes of
    an EP group in one exchange): it counts n times a turn's share."""
    return _turns_times(Fraction(1, n))


@contextlib.contextmanager
def of_blocks(n: int):
    """A call inside moves ``n`` ranks' blocks as one rank's payload (a
    replica's model blocks synced together on a ``StackedMesh``): its bytes
    count 1 / n, the call itself once."""
    c = _counter
    if c is None or n == 1:
        yield
        return
    c.blocks *= n
    try:
        yield
    finally:
        c.blocks //= n


def count_turns():
    """The turns a call made now counts in, for the backward of an
    ``autograd.Function`` to count in its forward's (``at_turns``); None
    with no count active."""
    return None if _counter is None else _counter.turns


@contextlib.contextmanager
def at_turns(turns):
    """The calls inside count in ``turns`` (``count_turns()`` of the forward):
    a backward runs outside the ``in_turns`` of its forward."""
    c = _counter
    if c is None or turns is None:
        yield
        return
    outer, c.turns = c.turns, turns
    try:
        yield
    finally:
        c.turns = outer


@contextlib.contextmanager
def counted_as(kind: str, nbytes: int):
    """The collectives inside count as one of ``kind`` of ``nbytes`` a rank
    (``pmean``: a mean over a group, built from one all-to-all of copies,
    is the all-reduce JAX's ``psum`` is)."""
    global _counter
    c = _counter
    if c is None:
        yield
        return
    _counter = None
    try:
        yield
    finally:
        _counter = c
    c.add(kind, nbytes)


def count_stacked(mesh, kind: str, nbytes: int) -> None:
    """A collective that a ``StackedMesh`` does as a view (a ``DistMesh`` by
    its primitive, which counts itself): ``nbytes`` a rank's output."""
    if _counter is not None and isinstance(mesh, StackedMesh):
        _counter.add(kind, nbytes)


def _tail_bytes(x: torch.Tensor, n_lead: int) -> int:
    """Bytes of the dimensions after the first ``n_lead``: a rank's share."""
    return math.prod(x.shape[n_lead:]) * x.element_size()


class _Mesh:
    """What both meshes know: named axes and their sizes."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], device):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes) or \
                min(shape, default=0) < 1:
            raise ValueError(f"need one positive size per distinct axis, got "
                             f"shape {shape} axes {axes}")
        self.axis_names = axes
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.device = resolve_device(device)

    def size(self, axes: Sequence[str]) -> int:
        """Number of ranks in a group over ``axes``."""
        return math.prod(self.shape[a] for a in axes)

    def _sorted(self, axes: Sequence[str]) -> Tuple[str, ...]:
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in the mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)


class StackedMesh(_Mesh):
    """Every replica on one device, stacked on a leading dimension.

    ``ranks``: for each rank, row-major, which rank of the original mesh it
    is (by default itself): ``train.elastic.shrink_mesh`` records there which
    survivors the new mesh's ranks are.  On one device this is bookkeeping;
    nothing moves."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], device, ranks=None):
        super().__init__(shape, axes, device)
        n = self.size(self.axis_names)
        self.ranks = tuple(range(n)) if ranks is None else tuple(int(r) for r in ranks)
        if len(self.ranks) != n:
            raise ValueError(f"{len(self.ranks)} ranks recorded for a mesh of {n}")

    def rows(self, axes: Sequence[str]) -> int:
        """Leading replica dimension of a stacked leaf synced over ``axes``."""
        return self.size(axes)

    def local(self, g: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """(R, ...) with R = size(axes), replica index row-major over ``axes``
        in the order given → the local form ``lead + (n,)`` (a view)."""
        if g.device != self.device:
            raise ValueError(f"the mesh lives on {self.device}, a tensor on {g.device}")
        sizes = [self.shape[a] for a in axes]
        if g.dim() < 1 or g.shape[0] != math.prod(sizes):
            raise ValueError(f"need a leading replica dimension of {math.prod(sizes)} "
                             f"over {tuple(axes)}, got {tuple(g.shape)}")
        x = g.reshape(*sizes, math.prod(g.shape[1:]))
        x = x.permute(*sorted(range(len(axes)), key=lambda i: self.axis_names.index(axes[i])),
                      len(axes))
        return x.reshape(*(self.shape[a] if a in axes else 1 for a in self.axis_names),
                         x.shape[-1])

    def stacked(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The local form → ``(R, m)``, replica index row-major over ``axes``
        in the order given (the inverse of ``local``)."""
        nl = len(self.axis_names)
        x = x.expand(*(self.shape[a] if a in axes else 1 for a in self.axis_names),
                     x.shape[-1])
        in_mesh_order = self._sorted(axes)
        x = x.reshape(*(self.shape[a] for a in in_mesh_order), x.shape[-1]) \
            if len(in_mesh_order) < nl else x
        x = x.permute(*(in_mesh_order.index(a) for a in axes), len(axes))
        return x.reshape(self.size(axes), x.shape[-1])

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """A local tensor equal on every replica → one copy ``(m,)``."""
        nl = len(self.axis_names)
        if any(s != 1 for s in x.shape[:nl]):
            raise ValueError(f"not replicated: leading dimensions {tuple(x.shape[:nl])}")
        return x.reshape(x.shape[nl:])

    def exchange(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """All-to-all over ``axes``: each rank's ``(G·s,)`` is G chunks, chunk
        j for the rank of group index j.  Returns ``lead + (G, s)``: what
        arrived, by sending rank.  A strided view of x."""
        axes = self._sorted(axes)
        nl, G = len(self.axis_names), self.size(axes)
        if x.shape[-1] % G:
            raise ValueError(f"exchange over {axes}: {x.shape[-1]} is not a multiple of {G}")
        x = x.expand(*(self.shape[a] if a in axes else s
                       for a, s in zip(self.axis_names, x.shape)), x.shape[-1])
        x = x.reshape(*x.shape[:nl], *(self.shape[a] for a in axes), x.shape[-1] // G)
        for j, a in enumerate(axes):        # sender's coordinate <-> chunk index
            x = x.transpose(self.axis_names.index(a), nl + j)
        x = x.flatten(nl, nl + len(axes) - 1)
        if _counter is not None and G > 1:
            _counter.add("all-to-all", _tail_bytes(x, nl))
        return x

    def gather(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """All-gather over ``axes``: ``lead + (m,)`` → ``lead' + (G, m)``, entry
        j the value of the rank of group index j; ``lead'`` is 1 on ``axes``
        (every rank of the group holds the same).  A strided view of x."""
        axes = self._sorted(axes)
        nl, k = len(self.axis_names), len(axes)
        pos = [self.axis_names.index(a) for a in axes]
        x = x.expand(*(self.shape[a] if a in axes else s
                       for a, s in zip(self.axis_names, x.shape)), x.shape[-1])
        x = x.movedim(pos, list(range(nl - k, nl))).flatten(nl - k, nl - 1)
        for p in pos:
            x = x.unsqueeze(p)
        if _counter is not None and self.size(axes) > 1:
            _counter.add("all-gather", _tail_bytes(x, nl))
        return x

    def permute(self, x: torch.Tensor, axis: str, shift: int) -> torch.Tensor:
        """Cyclic shift along ``axis``: the rank at coordinate i receives what
        the rank at i - ``shift`` holds.  x: the local form (one leading
        dimension per mesh axis, then any shape).  A roll of the axis's
        leading dimension."""
        self._sorted((axis,))                 # an unknown axis raises
        pos = self.axis_names.index(axis)
        x = x.expand(*(self.shape[axis] if i == pos else s
                       for i, s in enumerate(x.shape[:len(self.axis_names)])),
                     *x.shape[len(self.axis_names):])
        if _counter is not None and shift % self.shape[axis]:
            _counter.add("collective-permute", _tail_bytes(x, len(self.axis_names)))
        return torch.roll(x, shift, dims=pos)

    def row_coords(self, axis: str) -> List[int]:
        """The coordinate along ``axis`` of each row of a tensor in the rows
        form over ``(axis,)``."""
        self._sorted((axis,))
        return list(range(self.shape[axis]))


class DistMesh(_Mesh):
    """One replica per ``torch.distributed`` rank; rank r has the mesh
    coordinates of r row-major over the axes."""

    def __init__(self, shape, axes, device):
        super().__init__(shape, axes, device)
        if not dist.is_initialized():
            raise RuntimeError("make_dist_mesh needs torch.distributed.init_process_group first")
        world = dist.get_world_size()
        if world != math.prod(self.shape.values()):
            raise ValueError(f"mesh {tuple(self.shape.values())} needs "
                             f"{math.prod(self.shape.values())} ranks, the world has {world}")
        self.rank = dist.get_rank()
        grid = np.arange(world).reshape(tuple(self.shape.values()))
        self.coords = dict(zip(self.axis_names, np.unravel_index(self.rank, grid.shape)))
        # every rank creates every group, in one order (new_group is collective)
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._group_ranks: Dict[Tuple[str, ...], List[int]] = {}
        for k in range(1, len(self.axis_names) + 1):
            for axes_ in itertools.combinations(self.axis_names, k):
                keep = [self.axis_names.index(a) for a in axes_]
                moved = np.moveaxis(grid, keep, list(range(len(grid.shape) - k, len(grid.shape))))
                for ranks in moved.reshape(-1, self.size(axes_)):
                    group = dist.new_group([int(r) for r in ranks])
                    if self.rank in ranks:
                        self._groups[axes_] = group
                        self._group_ranks[axes_] = [int(r) for r in ranks]

    def rows(self, axes: Sequence[str]) -> int:
        """Leading replica dimension of this rank's block of a stacked leaf."""
        return 1

    def replica(self, axes: Sequence[str]) -> int:
        """This rank's replica index, row-major over ``axes`` in the order
        given: the row of a stacked tensor it holds."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + int(self.coords[a])
        return idx

    def local(self, g: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """(1, ...): this rank's block of a stacked leaf → ``(n,)``."""
        if g.device != self.device:
            raise ValueError(f"the mesh lives on {self.device}, a tensor on {g.device}")
        if g.dim() < 1 or g.shape[0] != 1:
            raise ValueError(f"need this rank's block (1, ...), got {tuple(g.shape)}")
        return g.reshape(-1)

    def stacked(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        return x.reshape(1, x.shape[-1])

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def exchange(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        axes = self._sorted(axes)
        G = self.size(axes)
        if x.shape[-1] % G:
            raise ValueError(f"exchange over {axes}: {x.shape[-1]} is not a multiple of {G}")
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=self._groups[axes])
        if _counter is not None and G > 1:
            _counter.add("all-to-all", _tail_bytes(out, 0))
        return out.view(G, -1)

    def gather(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        axes = self._sorted(axes)
        G = self.size(axes)
        # the concatenated form: gloo does not take the stacked one
        out = torch.empty(G * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=self._groups[axes])
        if _counter is not None and G > 1:
            _counter.add("all-gather", _tail_bytes(out, 0))
        return out.view((G,) + tuple(x.shape))

    def permute(self, x: torch.Tensor, axis: str, shift: int) -> torch.Tensor:
        """Cyclic shift along ``axis``: this rank sends x to the rank
        ``shift`` further along the axis and receives from the one ``shift``
        before it (``batch_isend_irecv`` over the axis's group)."""
        axes = self._sorted((axis,))
        n, c = self.shape[axis], int(self.coords[axis])
        if shift % n == 0:
            return x.clone()
        ranks = self._group_ranks[axes]
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[(c + shift) % n],
                          self._groups[axes]),
               dist.P2POp(dist.irecv, out, ranks[(c - shift) % n], self._groups[axes])]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if _counter is not None:
            _counter.add("collective-permute", _tail_bytes(out, 0))
        return out

    def row_coords(self, axis: str) -> List[int]:
        self._sorted((axis,))
        return [int(self.coords[axis])]


def any_rank(mesh, flag: bool) -> bool:
    """Whether ``flag`` is true on any rank of ``mesh``: on a ``DistMesh``
    one all-reduce (max) over the world, so that every rank gets the same
    answer at the same point of its program; on a ``StackedMesh`` (one
    process) the flag itself."""
    if not isinstance(mesh, DistMesh):
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


class _AllToAll(torch.autograd.Function):
    """``mesh.exchange`` in the rows form.  An exchange swaps the sending
    rank with the block index, so applying it twice is the identity: the
    backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.turns = mesh, axes, count_turns()
        return _exchange_rows(mesh, x, axes)

    @staticmethod
    def backward(ctx, g):
        with at_turns(ctx.turns):
            return _exchange_rows(ctx.mesh, g, ctx.axes), None, None


def _exchange_rows(mesh, x: torch.Tensor, axes) -> torch.Tensor:
    got = mesh.exchange(mesh.local(x, axes), axes)
    return mesh.stacked(got.reshape(*got.shape[:-2], -1), axes).reshape(x.shape)


class _Permute(torch.autograd.Function):
    """``mesh.permute`` in the rows form; the backward shifts back."""

    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift, ctx.turns = mesh, axis, shift, count_turns()
        return _permute_rows(mesh, x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        with at_turns(ctx.turns):
            return _permute_rows(ctx.mesh, g, ctx.axis, -ctx.shift), None, None, None


def _permute_rows(mesh, x: torch.Tensor, axis: str, shift: int) -> torch.Tensor:
    if isinstance(mesh, DistMesh):
        return mesh.permute(x, axis, shift)
    lead = tuple(mesh.shape[a] if a == axis else 1 for a in mesh.axis_names)
    out = mesh.permute(x.reshape(*lead, *x.shape[1:]), axis, shift)
    return out.reshape(x.shape)


def _check_rows(mesh, x: torch.Tensor, axes: Sequence[str], what: str) -> None:
    if x.dim() < 1 or x.shape[0] != mesh.rows(axes):
        raise ValueError(f"{what}: need the rows form, a leading dimension of "
                         f"{mesh.rows(axes)} over {tuple(axes)}, got {tuple(x.shape)}")


def all_to_all(mesh, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Differentiable all-to-all over ``axes``.  x: (R, G, ...) in the rows
    form, block j (``x[:, j]``) for the rank of group index j; returns (R, G,
    ...), block j what the rank of group index j sent this one."""
    axes = tuple(axes)
    _check_rows(mesh, x, axes, "all_to_all")
    if x.dim() < 2 or x.shape[1] != mesh.size(axes):
        raise ValueError(f"all_to_all over {axes}: need {mesh.size(axes)} blocks in "
                         f"dimension 1, got {tuple(x.shape)}")
    return _AllToAll.apply(x, mesh, axes)


def ppermute(mesh, x: torch.Tensor, axis: str, shift: int) -> torch.Tensor:
    """Differentiable cyclic shift along ``axis``: the rank at coordinate i
    gets what the rank at i - ``shift`` holds.  x: (R, ...) in the rows form
    over ``(axis,)``."""
    _check_rows(mesh, x, (axis,), "ppermute")
    return _Permute.apply(x, mesh, axis, int(shift))


def pmean(mesh, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Differentiable mean over the ranks of ``axes``.  x: (R, ...) in the
    rows form; returns x.shape[1:], the same on every rank: every rank's
    value sent to every other (``all_to_all``), then the mean of what
    arrived, in group order."""
    axes = tuple(axes)
    _check_rows(mesh, x, axes, "pmean")
    G = mesh.size(axes)
    with counted_as("all-reduce", x[0].numel() * x.element_size()):
        got = all_to_all(mesh, x.unsqueeze(1).expand(x.shape[0], G, *x.shape[1:]), axes)
    return got.mean(dim=1)[0]


def make_production_mesh(*, multi_pod: bool = False) -> StackedMesh:
    """(16, 16) ``(data, model)`` single-pod or (2, 16, 16) ``(pod, data,
    model)`` multi-pod mesh, for placement metadata (on the meta device:
    nothing is allocated there)."""
    if multi_pod:
        return StackedMesh((2, 16, 16), ("pod", "data", "model"), "meta")
    return StackedMesh((16, 16), ("data", "model"), "meta")


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device="cuda") -> StackedMesh:
    """Every replica of the mesh on one device (the stacked transport)."""
    return StackedMesh(shape, axes, device)


def make_dist_mesh(shape: Sequence[int], axes: Sequence[str], *,
                   device="cuda") -> DistMesh:
    """One replica per rank of the initialised ``torch.distributed`` world,
    whose size must equal ``prod(shape)``; ``device`` is where this rank's
    tensors live (the CPU for ``gloo``)."""
    return DistMesh(shape, axes, device)
