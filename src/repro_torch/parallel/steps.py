"""Train steps, and the placement metadata of a cell.

Counterpart of ``repro.parallel.steps``.

``make_train_step(cfg, pcfg, ocfg)`` returns ``step(state, batch) ->
(state, metrics)`` on one device: the loss of the batch, its gradient by
``backward`` through the model (on the card every self-attention's through
the flash-attention backward kernel, every Mamba2 scan's through the SSD-scan
backward kernel), then AdamW.  The parameters and the optimizer state are
updated in place (``train.optim``), so the returned ``TrainState`` holds the
tensors of the one passed in.  Metrics, as in the JAX step: ``loss``,
``aux_loss``, ``tokens``, ``grad_norm``, ``lr`` (0-d tensors; reading one
waits for the step).  A vlm batch carries ``patch_embeds`` (B, n_patches, d)
and its ``tokens`` / ``labels`` the text after them; an audio batch carries
``frames`` (B, enc_seq, d), which the step encodes through ``_enc_fn``, as the
JAX ``make_train_setup`` does.

The placement metadata of a cell, leaf for leaf as the JAX package's, with
specs as tuples (``parallel.sharding``) and shapes as tensors on the meta
device (the JAX ``ShapeDtypeStruct``): ``input_specs``, ``batch_shardings``,
``opt_state_shardings`` (int8 moments' ``QTensor`` too), ``make_layer_constrain``
(the specs its JAX closure pins a block to) and ``CellSetup``.

``make_train_setup(cfg, shape, mesh, pcfg, ocfg)`` is the data-parallel train
step over a mesh of ``launch.mesh``, with the parameters ``replicated`` or the
optimizer state sharded ``zero1``: each rank takes the gradient of its shard
of the batch (``Ruleset.batch_axes``), the gradients are synchronised by
FRED's schedule (``parallel.collectives.build_sync``: on the card through the
tree-reduce kernel), and AdamW updates the whole state (replicated) or each
rank's ``opt_spec`` shard of master and moments, whose parameter slices are
then put together again (zero1; on a ``DistMesh`` by an all-gather).  What the
setup cannot run yet it refuses with a ``ValueError``: FSDP, a model-parallel
axis of more than one rank, expert parallelism and the prefill / decode
setups wait for ROADMAP.md M9b2b.

``moe_ep_ffn_fn`` binds the expert-parallel FFN to a ``Ruleset``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..launch.mesh import DistMesh, StackedMesh
from ..models import transformer as tfm
from ..models import whisper
from ..models.moe import moe_ffn_ep
from ..models.config import ModelConfig, ParallelConfig, ShapeConfig
from ..models.modules import tree_flatten, tree_map, tree_unflatten
from ..train.optim import AdamState, OptimConfig, QTensor, adam_update, global_norm, init_adam
from .collectives import build_sync
from .sharding import Ruleset, _spec, shard_leaf, unshard_leaf


class TrainState(NamedTuple):
    params: Any
    opt: AdamState


INTEGER_INPUTS = ("tokens", "labels")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def batch_to_device(batch: Dict[str, Any], device, dtype: torch.dtype
                    ) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``: the token
    ids and labels as int64, the embeddings (``patch_embeds``, ``frames``) in
    ``dtype``, the parameters' dtype, as the JAX ``input_specs`` gives them the
    compute dtype."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                else v).to(device=device,
                           dtype=torch.int64 if k in INTEGER_INPUTS else dtype)
            for k, v in batch.items()}


def _enc_fn(cfg: ModelConfig, pcfg: ParallelConfig):
    """The encoder of an audio model as ``loss_fn`` / ``prefill`` take it, or
    None for the other families."""
    if cfg.family != "audio":
        return None
    return lambda p, b: whisper.encode(p, b, cfg, pcfg)


def train_grads(params, batch, cfg: ModelConfig, pcfg: ParallelConfig, enc_fn=None,
                loss_weight=None):
    """(gradient tree, metrics) of ``loss_fn`` at ``params`` on ``batch``; the
    parameters are left as they are."""
    leaves, spec = tree_flatten(params)
    # the same storage, as leaves of a fresh autograd graph
    live = [p.detach().requires_grad_() for p in leaves]
    batch = batch_to_device(batch, leaves[0].device, leaves[0].dtype)
    total, metrics = tfm.loss_fn(tree_unflatten(spec, live), batch, cfg, pcfg,
                                 enc_fn=enc_fn, loss_weight=loss_weight)
    total.backward()
    grads = [p.grad for p in live]
    del live, total
    return tree_unflatten(spec, grads), metrics


def make_train_step(cfg: ModelConfig, pcfg: Optional[ParallelConfig] = None,
                    ocfg: Optional[OptimConfig] = None
                    ) -> Callable[[TrainState, Dict[str, Any]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    pcfg = pcfg or ParallelConfig()
    ocfg = ocfg or OptimConfig()
    enc_fn = _enc_fn(cfg, pcfg)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        grads, metrics = train_grads(state.params, batch, cfg, pcfg, enc_fn)
        params, opt, om = adam_update(state.params, grads, state.opt, ocfg)
        return TrainState(params, opt), {**metrics, **om}

    return train_step


# --------------------------------------------------------------------------
# placement metadata
# --------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig, pcfg: ParallelConfig
                ) -> Dict[str, torch.Tensor]:
    """The model inputs of one cell as tensors on the meta device (shapes
    and dtypes, nothing allocated), as the JAX ``ShapeDtypeStruct``s: token
    ids int32 (``batch_to_device`` takes them to int64), the modality stubs'
    embeddings in the compute dtype."""
    B, S = shape.global_batch, shape.seq_len
    cdt = DTYPES[pcfg.compute_dtype]

    def sd(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": sd((B, 1), torch.int32)}
    batch = {}
    s_text = S
    if cfg.family == "vlm":
        batch["patch_embeds"] = sd((B, cfg.n_patches, cfg.d_model), cdt)
        s_text = S - cfg.n_patches
    if cfg.family == "audio":
        batch["frames"] = sd((B, cfg.enc_seq, cfg.d_model), cdt)
    batch["tokens"] = sd((B, s_text), torch.int32)
    if shape.kind == "train":
        batch["labels"] = sd((B, s_text), torch.int32)
    return batch


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, ruleset: Ruleset
                    ) -> Dict[str, Tuple]:
    """The spec of each input: the batch dim over ``batch_axes``."""
    b = ruleset.batch_axes(shape.global_batch)
    return {k: _spec((b, None, None)) if k in ("patch_embeds", "frames") else _spec((b, None))
            for k in input_specs(cfg, shape, ruleset.pcfg)}


def opt_state_shardings(ruleset: Ruleset, axes, ocfg: OptimConfig) -> AdamState:
    """The specs of ``init_adam``'s state for a tree of axis-name tuples:
    ``opt_spec`` of every leaf (ZeRO-1's data shard on the ``embed`` dim);
    an int8 moment's ``scale`` takes its row's spec without the last entry."""
    def moment(a):
        row = ruleset.opt_spec(a)
        if ocfg.moments_dtype == "int8":
            return QTensor(q=row, scale=row[:-1])
        return row

    return AdamState(step=(),
                     master=tree_map(ruleset.opt_spec, axes) if ocfg.master else None,
                     m=tree_map(moment, axes), v=tree_map(moment, axes))


def make_layer_constrain(ruleset: Ruleset, axes_blocks):
    """The stored placement of one block's parameters, ``layers`` dropped, for
    the stacked blocks' axes ``axes_blocks`` (``param_axes(cfg)["blocks"]``).
    The JAX function returns a closure that pins a block's slice to these
    specs; on one device there is nothing to pin, so this returns the specs."""
    return tree_map(lambda a: ruleset.spec(a[1:]), axes_blocks)


@dataclasses.dataclass
class CellSetup:
    """Everything one (arch x shape x mesh) cell needs: the JAX fields (the
    shapes on the meta device, the specs as tuples, ``step_fn`` the step
    itself), then the port's own: ``init_state(params) -> TrainState`` places
    a state for ``step_fn``; ``grad_fn(state, batch) -> (synced gradients,
    metrics)`` and ``update_fn(state, grads) -> (state, metrics)`` are the
    step's two halves."""
    cfg: ModelConfig
    pcfg: ParallelConfig
    shape: ShapeConfig
    mesh: Any
    ruleset: Ruleset
    param_shapes: Any
    param_shardings: Any
    step_fn: Any
    example_args: Tuple
    state_shapes: Any = None
    state_shardings: Any = None
    init_state: Optional[Callable] = None
    grad_fn: Optional[Callable] = None
    update_fn: Optional[Callable] = None


def _param_setup(cfg: ModelConfig, pcfg: ParallelConfig, mesh):
    """(ruleset, parameter shapes on the meta device, the axes in the port's
    layout, their specs)."""
    ruleset = Ruleset(mesh, cfg, pcfg)
    param_shapes = tfm.init(None, cfg, dtype=DTYPES[pcfg.param_dtype], device="meta")
    axes = tfm.param_axes(cfg, stacked=False)
    return ruleset, param_shapes, axes, ruleset.param_shardings(axes)


# --------------------------------------------------------------------------
# the data-parallel train setup
# --------------------------------------------------------------------------

SETUP_SHARDINGS = ("replicated", "zero1")
SETUP_SYNCS = ("flat", "hierarchical")


def _sync_axes(cfg, shape, mesh, pcfg, ocfg, ruleset) -> Tuple[str, Optional[str]]:
    """(inner, outer) data axes of the gradient sync; a ``ValueError`` for
    what the setup does not run."""
    if shape.kind != "train":
        raise ValueError(f"make_train_setup: a {shape.kind!r} shape; the prefill and "
                         "decode setups wait for ROADMAP.md M9b2b")
    if not isinstance(mesh, (StackedMesh, DistMesh)):
        raise TypeError(f"make_train_setup needs a mesh of launch.mesh, got {type(mesh).__name__}")
    if pcfg.param_sharding not in SETUP_SHARDINGS:
        raise ValueError(
            f"make_train_setup: param_sharding={pcfg.param_sharding!r} (the ParallelConfig "
            f"default is 'fsdp'); the setup runs {SETUP_SHARDINGS}, FSDP waits for "
            "ROADMAP.md M9b2b")
    idle = [a for a in mesh.axis_names if mesh.shape[a] > 1 and a not in ruleset.dp]
    if idle:
        raise ValueError(
            f"make_train_setup: mesh axes {idle} of more than one rank carry no data "
            f"parallelism (tensor parallelism over {pcfg.tp_axis or 'model'!r} waits for "
            "ROADMAP.md M9b2b)")
    if pcfg.grad_sync not in SETUP_SYNCS:
        raise ValueError(
            f"make_train_setup: grad_sync={pcfg.grad_sync!r}; the JAX setup's gradient "
            "reduction is exact, and the int8 cross-pod phase of 'compressed' would give "
            f"a different result, not the same one faster: use one of {SETUP_SYNCS}")
    if pcfg.param_sharding == "zero1" and ocfg.moments_dtype == "int8":
        raise ValueError(
            "make_train_setup: int8 moments under zero1; the JAX moment's scale spans "
            "the whole row and a rank's shard would take its own (ROADMAP.md M9b2b)")
    if ruleset.ep_axis:
        raise ValueError(
            f"make_train_setup: moe_ep_axis={pcfg.moe_ep_axis!r}; placing the experts over "
            "a data axis in the setup waits for ROADMAP.md M9b2b (moe_ep_ffn_fn runs "
            "expert parallelism on its own)")
    dp = ruleset.dp
    if not dp:
        raise ValueError(f"make_train_setup: the mesh {mesh.axis_names} has no data axis")
    inner = dp[-1]
    outer = "pod" if "pod" in dp and inner != "pod" else None
    extra = [a for a in dp if a not in (inner, outer)]
    if extra:
        raise ValueError(f"make_train_setup: data axes {dp}; the sync reduces over "
                         f"{inner!r} and 'pod' only (ROADMAP.md M9b2b)")
    return inner, outer


def make_train_setup(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     pcfg: Optional[ParallelConfig] = None,
                     ocfg: Optional[OptimConfig] = None) -> CellSetup:
    """The data-parallel train step of one cell over ``mesh`` (a
    ``StackedMesh``: every rank in turn on its device, the gradients stacked
    on a leading rank dimension; a ``DistMesh``: this rank, the others
    through ``torch.distributed``).  ``step_fn(state, batch)`` takes the whole
    batch on every rank, as the JAX step takes the global array."""
    pcfg = pcfg or ParallelConfig()
    ocfg = ocfg or OptimConfig()
    ruleset, param_shapes, axes, param_shardings = _param_setup(cfg, pcfg, mesh)
    inner, outer = _sync_axes(cfg, shape, mesh, pcfg, ocfg, ruleset)
    sync_axes = tuple(a for a in (outer, inner) if a)
    sync = build_sync(mesh, pcfg.grad_sync, inner_axis=inner, outer_axis=outer)
    b_axes = ruleset.batch_axes(shape.global_batch) or ()
    n_rows = mesh.size(b_axes)              # distinct shards of the batch
    zero1 = pcfg.param_sharding == "zero1"
    enc_fn = _enc_fn(cfg, pcfg)
    opt_shardings = opt_state_shardings(ruleset, axes, ocfg)
    is_spec = lambda x: isinstance(x, tuple)            # noqa: E731
    opt_specs = tree_flatten(tree_map(ruleset.opt_spec, axes), is_leaf=is_spec)[0]

    # the batch row of each sync replica (row-major over the sync axes);
    # ranks along a data axis the batch does not divide over share a row
    def batch_row(coords):
        row = 0
        for a in b_axes:
            row = row * mesh.shape[a] + coords[sync_axes.index(a)]
        return row
    replica_rows = [batch_row(c) for c in
                    itertools.product(*(range(mesh.shape[a]) for a in sync_axes))]

    def init_state(params) -> TrainState:
        """The optimizer state for ``params`` (this rank's whole tree):
        replicated, ``init_adam`` of the whole tree; zero1, of each leaf's
        ``opt_spec`` shard in the rows form (on a ``DistMesh`` a copy of
        this rank's shard alone)."""
        if not zero1:
            return TrainState(params, init_adam(params, ocfg))
        leaves, spec = tree_flatten(params)
        rows = [shard_leaf(p, s, mesh) for p, s in zip(leaves, opt_specs)]
        return TrainState(params, init_adam(tree_unflatten(spec, rows), ocfg))

    def grad_fn(state: TrainState, batch) -> Tuple[Any, Dict[str, torch.Tensor]]:
        leaves = tree_flatten(state.params)[0]
        batch = batch_to_device(batch, leaves[0].device, leaves[0].dtype)
        placed = {k: shard_leaf(v, (b_axes,), mesh) for k, v in batch.items()}
        labelled = (batch["labels"] >= 0).sum()
        denom = labelled.clamp_min(1).float()
        counts = (placed["labels"] >= 0).flatten(1).sum(1).float()      # (rows,)
        # a rank's mean weighed by its share of the labelled tokens: the
        # mean of the ranks' gradients is the gradient of the global mean
        weights = counts * n_rows / denom
        stacked, part = None, []
        if isinstance(mesh, DistMesh):
            rows = [(0, [0])]
        else:
            rows = [(j, [i for i, r in enumerate(replica_rows) if r == j])
                    for j in range(n_rows)]
        for j, replicas in rows:
            g, m = train_grads(state.params, {k: v[j] for k, v in placed.items()},
                               cfg, pcfg, enc_fn, loss_weight=weights[j])
            g_leaves, spec = tree_flatten(g)
            if isinstance(mesh, DistMesh):
                stacked = [t.unsqueeze(0) for t in g_leaves]
            else:
                if stacked is None:
                    stacked = [t.new_empty((len(replica_rows),) + tuple(t.shape))
                               for t in g_leaves]
                for buf, t in zip(stacked, g_leaves):
                    for i in replicas:
                        buf[i].copy_(t)
            del g, g_leaves
            part.append(torch.stack([m["loss"] * counts[j], m["aux_loss"]]))
        synced = sync(tree_unflatten(spec, stacked))
        del stacked
        # every batch row's (loss x count, aux), row-major over the batch axes
        vals = unshard_leaf(torch.stack(part)[:, None], (b_axes,), mesh)
        metrics = {"loss": vals[:, 0].sum() / denom, "aux_loss": vals[:, 1].mean(),
                   "tokens": denom}
        return synced, metrics

    def update_fn(state: TrainState, grads) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if not zero1:
            params, opt, om = adam_update(state.params, grads, state.opt, ocfg)
            return TrainState(params, opt), om
        # the clip factor from the norm of the whole synced gradient
        gnorm = global_norm(grads)
        leaves, spec = tree_flatten(state.params)
        g_leaves = tree_flatten(grads)[0]
        p_rows = [shard_leaf(p, s, mesh) for p, s in zip(leaves, opt_specs)]
        g_rows = [shard_leaf(g, s, mesh) for g, s in zip(g_leaves, opt_specs)]
        _, opt, om = adam_update(tree_unflatten(spec, p_rows), tree_unflatten(spec, g_rows),
                                 state.opt, ocfg, gnorm=gnorm)
        for p, rows, s in zip(leaves, p_rows, opt_specs):
            full = unshard_leaf(rows, s, mesh)
            if full.untyped_storage().data_ptr() != p.untyped_storage().data_ptr():
                p.copy_(full)          # rows was a copy (or one rank's shard)
        return TrainState(state.params, opt), om

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        grads, metrics = grad_fn(state, batch)
        state, om = update_fn(state, grads)
        return state, {**metrics, **om}

    opt_shapes = init_adam(param_shapes, ocfg)
    state_shapes = TrainState(params=param_shapes, opt=opt_shapes)
    return CellSetup(cfg=cfg, pcfg=pcfg, shape=shape, mesh=mesh, ruleset=ruleset,
                     param_shapes=param_shapes, param_shardings=param_shardings,
                     step_fn=step_fn,
                     example_args=(state_shapes, input_specs(cfg, shape, pcfg)),
                     state_shapes=state_shapes,
                     state_shardings=TrainState(params=param_shardings, opt=opt_shardings),
                     init_state=init_state, grad_fn=grad_fn, update_fn=update_fn)


def moe_ep_ffn_fn(ruleset: Ruleset, cfg: ModelConfig):
    """Bind the all-to-all expert dispatch to a cell: ``f(params_ffn, x) ->
    (out, aux)`` runs ``models.moe.moe_ffn_ep`` on the ruleset's mesh over its
    EP axis (``pcfg.moe_ep_axis``), x and the expert weights in the rows form
    over that axis (``parallel.sharding.shard_leaf``).  Raises ``ValueError``
    when the ruleset has no EP axis: expert parallelism is a decision of the
    configuration, never a silent fallback."""
    if not ruleset.ep_axis:
        raise ValueError(
            "moe_ep_ffn_fn: the cell's ParallelConfig.moe_ep_axis is unset "
            "or invalid for this mesh / model; expert parallelism needs a "
            "data axis whose size divides n_experts")

    def f(params_ffn, x):
        return moe_ffn_ep(params_ffn, x, cfg, mesh=ruleset.mesh, ep_axis=ruleset.ep_axis)
    return f
