"""Logical-axis → mesh-axis sharding rules.

Counterpart of ``repro.parallel.sharding``: the port's own copy of
``Ruleset``'s rule table, the one place where the parallelisation policy
becomes a placement.  Model code names *logical* axes (``embed``, ``heads``,
``expert``, ...), a mesh has *physical* ones (``pod`` / ``data`` / ``model``);
``Ruleset.spec(axes)`` translates.  The policy, as in the JAX package:

* TP axes (vocab / heads / kv / mlp / ssm_in / qkv) map to the TP axis
  (``pcfg.tp_axis``, ``model``); query heads that do not divide the TP degree
  still shard unless the arch asks for ``attn_sharding='context'``.
* KV heads count as sharded only when they divide the TP degree.
* ``embed`` (d_model) shards over the last data axis under
  ``param_sharding='fsdp'`` (over every data axis when there is no TP axis);
  under ``zero1`` only the optimizer state does (``opt_spec``); under
  ``replicated`` neither.
* MoE ``expert`` shards over the TP axis when it divides the expert count,
  else the experts stay whole and their ``mlp`` dim takes the TP sharding.
  With ``pcfg.moe_ep_axis`` set to a data axis whose size divides the
  expert count, the experts shard over that axis instead (expert
  parallelism: ``models.moe.moe_ffn_ep``).

A spec is a tuple with one entry per dimension: ``None``, an axis name, or a
tuple of names, normalised as ``jax.sharding.PartitionSpec`` normalises it
(a tuple of one name is the name, an empty one ``None``), so that
``tuple(P(...))`` of the JAX spec equals it.  The ``Ruleset`` reads only the
mesh's ``shape`` (a mapping from axis name to size): either transport of
``launch.mesh``, or any object with that mapping.

``shard_leaf(t, spec, mesh)`` places a tensor by a spec: the stacked view of
every block on a ``StackedMesh``, this rank's block on a ``DistMesh`` (the
rows form of ``launch.mesh``); ``unshard_leaf`` puts the rows back together
(on a ``DistMesh`` by an all-gather over the spec's axes); ``all_blocks``
gives every block on either mesh, with no communication.  The expert weights
(dim 0 over ``ep_axis``), the batch (``batch_axes``), ZeRO-1's optimizer
shards (``opt_spec``) and FSDP's parameters (``spec``) are placed so.

The rest of the JAX ``Ruleset`` is here as metadata, leaf for leaf:
``param_shardings`` (a tree of specs; the port has no ``NamedSharding``),
``act_spec`` of every activation kind, ``constrain_spec`` (the spec
``constrain_fn``'s closure asks for after its adjustments to the value's
shape; on one device the closure itself returns its value), and the decode
state's ``kv_cache_spec``, ``ssm_state_spec`` and ``decode_state_shardings``
(the port's ``DecodeState`` structure).  The setups of ``parallel.steps``
place parameters by these specs over the data axes and, for every family,
over a ``model`` axis of more than one rank, whose products ``parallel.tp``
runs (tensor parallelism; a Mamba2 block's decode state in the rows form of
``ssm_state_spec``), and the MoE family's experts over an EP data axis
(``moe_ep_axis``); where ``kv_cache_spec`` puts the decode caches' sequence
on a mesh axis (KV heads that do not divide the TP degree, or a batch that
no data axis divides) the caches take the flash-decoding layout
(``parallel.tp.KVSeqContext``).  Sequence parallelism waits (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, Optional, Sequence, Tuple

import torch

from ..launch.mesh import DistMesh, StackedMesh, count_stacked
from ..models.config import ModelConfig, ParallelConfig
from ..models.layers import KVCache
from ..models.modules import tree_map
from ..models.ssm import SSMState
from ..models.transformer import DecodeState


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(mesh.shape[n] for n in name)
    return mesh.shape[name]


def _entry(e):
    """One dimension's entry as ``PartitionSpec`` keeps it."""
    if isinstance(e, tuple):
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


def _spec(entries: Iterable) -> Tuple:
    return tuple(_entry(e) for e in entries)


@dataclasses.dataclass
class Ruleset:
    mesh: Any
    cfg: ModelConfig
    pcfg: ParallelConfig

    def __post_init__(self):
        mesh, cfg, pcfg = self.mesh, self.cfg, self.pcfg
        tp = pcfg.tp_axis if pcfg.tp_axis in mesh.shape else None
        dp: Tuple[str, ...] = tuple(a for a in pcfg.dp_axes if a in mesh.shape)
        if "pod" in mesh.shape and "pod" not in dp:
            dp = ("pod",) + dp
        if tp is None and "model" in mesh.shape and \
                "model" not in dp and pcfg.tp_axis == "":
            # no TP: the model axis becomes more data parallelism
            dp = dp + ("model",)
        tp_size = _axis_size(mesh, tp)
        self.dp = dp
        self.tp = tp
        self.tp_size = tp_size
        fsdp = pcfg.param_sharding == "fsdp"
        # without TP, FSDP shards over every data axis
        fsdp_axis = (dp if tp is None else dp[-1]) if (fsdp and dp) else None

        kv_div = cfg.n_kv_heads > 0 and cfg.n_kv_heads % max(tp_size, 1) == 0
        heads_ok = cfg.n_heads > 0 and pcfg.attn_sharding != "context"
        exp_div = cfg.n_experts > 0 and cfg.n_experts % max(tp_size, 1) == 0
        # EP: experts shard over a *data* axis (all-to-all dispatch), their
        # hidden dim takes the TP sharding
        ep_axis = (pcfg.moe_ep_axis if pcfg.moe_ep_axis in mesh.shape and
                   cfg.n_experts and
                   cfg.n_experts % mesh.shape.get(pcfg.moe_ep_axis, 1) == 0
                   else None)
        self.ep_axis = ep_axis
        if ep_axis:
            exp_div = False

        self.kv_head_sharded = kv_div
        self.expert_sharded = exp_div

        self.rules = {
            "layers": None,
            "null": None,
            "embed": fsdp_axis,
            "embed_out": None,
            "vocab": tp if tp is not None else (tuple(dp) if fsdp else None),
            "qkv": tp,
            "heads": tp if heads_ok else None,
            "kv": tp,   # the flattened Hkv·hd dim, always divisible
            "mlp": None if exp_div else tp,
            "expert": ep_axis if ep_axis else (tp if exp_div else None),
            "expert_router": None,
            "ssm_in": tp,
            "embed_unsharded": None,
            "mlp_dense": tp if tp is not None else (dp[-1] if (fsdp and dp) else None),
            "ssm_head": tp if (cfg.ssm_heads and cfg.ssm_heads % max(tp_size, 1) == 0)
            else None,
        }
        # expert weights never take FSDP on the d_model contraction dim; it
        # goes on the f dim, with TP when the experts are not TP-sharded
        # (None without experts)
        self.expert_mlp_axis = None
        if cfg.n_experts:
            if ep_axis:
                self.expert_mlp_axis = tp                 # (data, None, model)
            elif exp_div:
                self.expert_mlp_axis = fsdp_axis          # (model, None, data)
            else:
                self.expert_mlp_axis = ((tp, fsdp_axis) if (tp and fsdp_axis)
                                        else (tp or fsdp_axis))

    # ---- parameters --------------------------------------------------------
    def spec(self, axes: Iterable[str]) -> Tuple:
        """The placement of a parameter with logical ``axes``."""
        names = tuple(axes)
        if "vocab" in names:
            # embedding / lm_head: the vocab dim carries the sharding, the
            # d_model dim (a contraction of the logits) none
            return _spec(self.rules.get(a) if a == "vocab" else None for a in names)
        if "expert" in names:
            # (expert, embed, mlp): FSDP lives on the mlp dim
            table = dict(self.rules)
            table["embed"] = None
            table["mlp"] = self.expert_mlp_axis
            return _spec(table.get(a) for a in names)
        return _spec(self.rules.get(a) for a in names)

    def opt_spec(self, axes: Iterable[str]) -> Tuple:
        """The optimizer state's placement: the parameter's, except that
        ZeRO-1 shards the 'embed' dim over the last data axis even where the
        parameter is replicated."""
        if self.pcfg.param_sharding != "zero1":
            return self.spec(axes)
        dp_last = self.dp[-1] if self.dp else None
        return _spec(dp_last if a == "embed" and self.rules.get(a) is None
                     else self.rules.get(a) for a in axes)

    def param_shardings(self, axes_tree):
        """The spec of every parameter of a tree of axis-name tuples
        (``models.transformer.param_axes``)."""
        return tree_map(self.spec, axes_tree)

    # ---- activations ---------------------------------------------------------
    def batch_axes(self, global_batch: int) -> Optional[Tuple[str, ...]]:
        """The data axes the batch shards over: as many as divide it,
        outermost first."""
        axes = []
        rem = global_batch
        for a in self.dp:
            s = self.mesh.shape[a]
            if rem % s == 0 and rem >= s:
                axes.append(a)
                rem //= s
        return tuple(axes) or None

    def act_spec(self, kind: str, global_batch: int) -> Tuple:
        """The placement of an activation of ``kind``: ``residual`` (B, S, d;
        S over TP under ``seq_shard``), ``logits`` (B, S, V), ``tokens`` (B,
        S), ``q_heads`` / ``kv_heads`` (B, S, H, hd), ``moe_buckets`` (G, E, C,
        d / f)."""
        b = self.batch_axes(global_batch)
        seq = self.tp if (self.pcfg.seq_shard and kind == "residual") else None
        if kind == "residual":
            return _spec((b, seq, None))
        if kind == "logits":
            return _spec((b, None, self.tp))
        if kind == "tokens":
            return _spec((b, None))
        if kind == "q_heads":
            # head counts that do not divide TP (56, 20) still shard
            return _spec((b, None, self.tp if self.rules.get("heads") else None, None))
        if kind == "kv_heads":
            # KV heads stay whole unless they divide TP
            return _spec((b, None, self.tp if self.kv_head_sharded else None, None))
        if kind == "moe_buckets":
            # EP: the experts carry the data axis and the groups stay whole;
            # else groups over data, experts over TP when expert-sharded, the
            # hidden dim otherwise
            if self.ep_axis:
                return _spec((None, self.ep_axis, None, None))
            e_ax = self.tp if self.expert_sharded else None
            f_ax = None if self.expert_sharded else self.tp
            return _spec((b, e_ax, None, f_ax))
        raise KeyError(kind)

    def constrain_spec(self, shape: Sequence[int], kind: str,
                       global_batch: int) -> Optional[Tuple]:
        """The spec ``constrain_fn``'s closure pins a value of ``shape`` to, or
        None where it leaves the value alone (its rank differs from the
        kind's).  Adjusted as the JAX closure adjusts it: a bucket d dim that
        does not divide TP, a residual seq dim that does not, and decode's
        single query position stay unsharded."""
        spec = list(self.act_spec(kind, global_batch))
        if len(shape) != len(spec):
            return None
        tp_size = max(self.tp_size, 1)
        if kind == "moe_buckets" and spec[3] is not None and shape[3] % tp_size:
            spec[3] = None
        if kind == "residual" and spec[1] is not None and shape[1] % tp_size:
            spec[1] = None
        if kind == "q_heads" and shape[1] == 1:
            spec[1] = None
        return tuple(spec)

    def constrain_fn(self, global_batch: int):
        """``constrain(x, kind="residual") -> x``: on one device there is
        nothing to pin; the spec it stands for is ``constrain_spec``."""
        def constrain(x, kind: str = "residual"):
            self.constrain_spec(tuple(x.shape), kind, global_batch)   # an unknown kind raises
            return x
        return constrain

    # ---- decode state --------------------------------------------------------
    def kv_cache_spec(self, global_batch: int) -> Tuple:
        """(L, B, S, Hkv, hd).  A batch too small for any data axis spreads
        the cache's sequence over every mesh axis (flash decoding)."""
        b = self.batch_axes(global_batch)
        if b is None:
            axes = tuple(a for a in (*self.dp, self.tp) if a)
            return _spec((None, None, axes, None, None))
        if self.kv_head_sharded:
            return _spec((None, b, None, self.tp, None))
        return _spec((None, b, self.tp, None, None))

    def ssm_state_spec(self, global_batch: int) -> Tuple[Tuple, Tuple]:
        """The SSM state h (L, B, H, hd, N) and conv lag (L, B, K-1, C)."""
        b = self.batch_axes(global_batch)
        return (_spec((None, b, self.rules["ssm_head"], None, None)),
                _spec((None, b, None, self.tp)))

    def decode_state_shardings(self, cfg: ModelConfig, global_batch: int):
        """The specs of a ``models.transformer.DecodeState``, field for field."""
        kv = ssm = shared = cross = None
        if cfg.family in ("ssm", "hybrid"):
            ssm = SSMState(*self.ssm_state_spec(global_batch))
            if cfg.family == "hybrid":
                shared = KVCache(self.kv_cache_spec(global_batch),
                                 self.kv_cache_spec(global_batch))
        else:
            kv = KVCache(self.kv_cache_spec(global_batch), self.kv_cache_spec(global_batch))
            if cfg.family == "audio":
                # the cross cache's seq is enc_seq (1500, not TP-divisible):
                # heads shard when they divide, the seq stays whole
                xspec = _spec((None, self.batch_axes(global_batch), None,
                               self.tp if self.kv_head_sharded else None, None))
                cross = KVCache(xspec, xspec)
        return DecodeState(kv=kv, ssm=ssm, shared_kv=shared, cross_kv=cross, index=())


def _names(e) -> Tuple[str, ...]:
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def _placement(t: torch.Tensor, spec, mesh):
    """(the axes of each spec entry, the ranks over each), checked against
    ``t`` and the mesh."""
    spec = tuple(spec)
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{t.dim()} dimensions")
    dims = [_names(e) for e in spec]
    every = [a for names in dims for a in names]
    if len(set(every)) != len(every):
        raise ValueError(f"spec {spec} names a mesh axis twice")
    unknown = set(every) - set(mesh.axis_names)
    if unknown:
        raise ValueError(f"axes {sorted(unknown)} are not in the mesh {mesh.axis_names}")
    parts = [math.prod(mesh.shape[a] for a in names) for names in dims]
    for i, (names, n) in enumerate(zip(dims, parts)):
        if t.shape[i] % n:
            raise ValueError(f"dimension {i} of {tuple(t.shape)} does not divide over "
                             f"{names} ({n} ranks)")
    return dims, parts


def shard_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``t`` placed by ``spec`` (one entry per leading dimension; the rest
    unsharded) in the rows form over the spec's axes, in the order they
    appear: on a ``StackedMesh`` (R, ...) with every rank's block, R the
    product of the axes' sizes (a view when only dimension 0 is sharded); on
    a ``DistMesh`` (1, ...) with this rank's.  A dimension over the axes (a,
    b) splits a-major, as a ``PartitionSpec`` splits it."""
    dims, parts = _placement(t, spec, mesh)
    if isinstance(mesh, DistMesh):
        for i, (names, n) in enumerate(zip(dims, parts)):
            if names:
                size = t.shape[i] // n
                t = t.narrow(i, mesh.replica(names) * size, size)
        return t.unsqueeze(0)
    if not isinstance(mesh, StackedMesh):
        raise TypeError(f"shard_leaf needs a mesh of launch.mesh, got {type(mesh).__name__}")
    return _stack_blocks(t, dims, parts, mesh)


def all_blocks(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """Every rank's block of ``t`` placed by ``spec``, ``(R, ...)`` as
    ``shard_leaf`` gives it on a ``StackedMesh``, on either mesh and without
    communication (on a ``DistMesh``: a rank's whole local gradient before
    its reduce-scatter)."""
    return _stack_blocks(t, *_placement(t, spec, mesh), mesh)


def _stack_blocks(t, dims, parts, mesh):
    shape, lead = [], []
    for i, size in enumerate(t.shape):
        names = dims[i] if i < len(dims) else ()
        lead += range(len(shape), len(shape) + len(names))
        shape += [mesh.shape[a] for a in names]
        shape.append(size // (parts[i] if i < len(dims) else 1))
    v = t.reshape(shape).movedim(lead, list(range(len(lead))))
    return v.reshape(math.prod(parts), *(s for i, s in enumerate(shape) if i not in lead))


def unshard_leaf(rows: torch.Tensor, spec, mesh, *, count: bool = True) -> torch.Tensor:
    """The inverse of ``shard_leaf``: the whole tensor from its rows form
    over ``spec``'s axes.  On a ``StackedMesh`` rows holds every block; on a
    ``DistMesh`` rows is this rank's (1, ...) block, and the others come by an
    all-gather over the spec's axes (a collective: every rank of the group
    calls it, in the same order).  On a ``StackedMesh`` the view counts as
    that all-gather (``launch.mesh.count_collectives``) unless ``count`` is
    false: a change of layout whose caller counts what a ``DistMesh`` moves
    for it."""
    spec = tuple(spec)
    block = tuple(rows.shape[1:])
    dims = [_names(e) for e in spec] + [()] * (len(block) - len(spec))
    every = [a for names in dims for a in names]
    if isinstance(mesh, DistMesh):
        if rows.shape[0] != 1:
            raise ValueError(f"need this rank's block (1, ...), got {tuple(rows.shape)}")
        if not every:
            return rows[0]
        in_mesh = mesh._sorted(every)
        got = mesh.gather(rows[0], in_mesh)             # (G, ...) in mesh order
        got = got.reshape(*(mesh.shape[a] for a in in_mesh), *block)
        rows = got.permute(*(in_mesh.index(a) for a in every),
                           *range(len(every), len(every) + len(block)))
    elif not isinstance(mesh, StackedMesh):
        raise TypeError(f"unshard_leaf needs a mesh of launch.mesh, got {type(mesh).__name__}")
    elif every and count:       # what a DistMesh rank's all-gather brings: the whole tensor
        count_stacked(mesh, "all-gather", rows.numel() * rows.element_size())
    rows = rows.reshape(tuple(mesh.shape[a] for a in every) + block)
    order, k = [], 0
    for i, names in enumerate(dims):
        order += range(k, k + len(names))
        k += len(names)
        order.append(len(every) + i)
    full = [b * math.prod(mesh.shape[a] for a in names) for b, names in zip(block, dims)]
    return rows.permute(order).reshape(full)
