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
step over a mesh of ``launch.mesh``, with the parameters ``replicated``, the
optimizer state sharded ``zero1``, or parameters and state sharded ``fsdp``
(the ``ParallelConfig`` default): each rank takes the gradient of its shard of
the batch (``Ruleset.batch_axes``), the gradients are synchronised by FRED's
schedule (on the card through the tree-reduce kernel: ``build_sync`` to the
whole mean, under fsdp ``build_shard_sync`` to each rank's block of it), and
AdamW updates the whole state (replicated) or each rank's block of master and
moments (zero1: ``opt_spec``, the parameter slices then put together again,
on a ``DistMesh`` by an all-gather; fsdp: ``spec``, and the parameters stay
in blocks).  Under fsdp each block's parameters are gathered right before the
block runs (``make_layer_gather``, the models' ``layer_constrain``), the
leaves outside the blocks once a call.  int8 moments take each row's scale
over the whole row, also where a rank holds a piece of it.

``make_prefill_setup`` / ``make_decode_setup`` / ``make_setup`` serve a cell
over the same placements: each rank prefills or steps its rows of the batch.

Tensor parallelism: a TP axis (``pcfg.tp_axis``, ``model``) of more than one
rank runs Megatron's split (``parallel.tp``) for every family.  Every sharding
then holds the parameters in the rows form of ``spec`` (which puts ``vocab`` /
``qkv`` / ``kv`` / ``mlp`` / ``ssm_in`` / ``ssm_head`` on the axis; the data
axes too under fsdp), the optimizer state in that of ``opt_spec``.  A
rank of a TP group computes with its model block of each leaf (under fsdp
gathered over the spec's data axes only) and the whole residual stream; on a
``StackedMesh`` the ranks of each batch row's TP group run in turn inside
every block.  A rank's gradient is its model block's; the sync runs over the
data axes for each model block (``build_sync`` of the blocks side by side,
under fsdp ``build_shard_sync`` of each), so a leaf whole over the axis (the
norms, ``mm_proj``, ``q_norm`` / ``k_norm``) is synced once.  The serving
setups keep each rank's KV heads in the decode state's rows form
(``kv_cache_spec``), a Mamba2 layer's SSM heads and conv channels likewise
(``ssm_state_spec``), and gather the logits whole.  The residual is not
sequence-sharded (``seq_shard`` is a placement in the JAX package, not a
different result).  Heads that do not divide the degree run as the JAX
package places them (``models.layers``): the query heads padded, the KV
heads gathered whole, and the serving setups keep the decode caches in the
flash-decoding layout of ``kv_cache_spec`` (``parallel.tp.KVSeqContext``:
each rank its block of the cache's sequence, every KV head), which a
serving batch that no data axis divides takes too: every data row then
computes the same prefill and each rank keeps its block of the sequence.  A
MoE block's router runs once on a TP group's whole input
(``models.moe.moe_ffn(tp=)``).  A Mamba2 block gathers its fused
in-projection and its conv output over the axis (``models.ssm.mamba2_forward(
tp=)``); the hybrid's shared attention block is placed (under fsdp gathered)
once a call, as every leaf outside the blocks.

Expert parallelism (``pcfg.moe_ep_axis``, the ``Ruleset``'s ``ep_axis``, a
data axis): the expert leaves are held over it (``spec`` ``('data', None,
'model')``: each rank its E / n experts, under TP their ``mlp`` block), and
the ranks of the axis, the lanes of an EP group, run together through the
model (``loss_fn`` / ``prefill`` / ``decode_step`` with ``ep=``, a
``parallel.tp.EPContext``): each lane's attention on its own sequences, then
every MoE block's all-to-all over the lanes (``models.moe.moe_ffn_lanes``).
As in the JAX setups each lane routes one group a sequence, so the result is
``moe_ffn``'s of the whole batch.  Each leaf the lanes share reaches every
lane through its own copy (``_GatherForGrad``, whose backward hands the
lane's gradient to a sink and sums nothing), so it keeps a per-lane gradient
for ``build_sync`` / ``build_shard_sync`` to average as before.  An expert
leaf's gradient already sums every lane's tokens (the all-to-all's
backward): it is divided by the lanes and reduced over the remaining data
axis (``pod``) only.  The EP axis must be the sync's inner axis and the
batch's last axis.

The state a train setup holds differs from the logical one by placement
(whole, the rows form of ``spec`` or of ``opt_spec``; an int8 moment's scale
one per rank's row), so ``CellSetup.state_to_logical`` gives the logical
state (``tfm.init``'s tree and ``init_adam``'s state, whole; on a
``DistMesh`` by all-gathers) and ``place_state`` is its inverse, leaf by
leaf through ``leaf_to_logical`` / ``place_leaf``: what
``train.checkpoint`` writes and restores, and what ``train.train_loop.
Trainer(mesh=)`` and ``train.elastic`` resume onto another mesh.

What the setups cannot run yet they refuse with a ``ValueError``: tensor
parallelism with SSM heads that do not divide the TP degree waits for
ROADMAP.md M9b2b (``models.ssm.tp_groups``); compressed sync would be a
different result; zero1 with ``moe_ep_axis`` set is refused as the JAX
setup refuses it (``opt_spec`` puts the data axis on the experts' ``embed``
dim beside their ``expert`` dim, a ``DuplicateSpecError`` there).

``moe_ep_ffn_fn`` binds the expert-parallel FFN to a ``Ruleset`` (on its own,
one group a rank: ``models.moe.moe_ffn_ep``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..launch.mesh import DistMesh, StackedMesh, count_stacked, in_turns, of_blocks
from ..models import transformer as tfm
from ..models import whisper
from ..models.moe import moe_ffn_ep
from ..models.ssm import tp_groups
from ..models.config import ModelConfig, ParallelConfig, ShapeConfig
from ..models.modules import tree_flatten, tree_map, tree_unflatten
from ..train.optim import AdamState, OptimConfig, QTensor, adam_update, init_adam
from .collectives import build_shard_sync, build_sync
from .sharding import Ruleset, _names, _spec, all_blocks, shard_leaf, unshard_leaf
from .tp import EPContext, KVSeqContext, TPContext


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


def _enc_fn(cfg: ModelConfig, pcfg: ParallelConfig, layer_constrain=None, tp=None):
    """The encoder of an audio model as ``loss_fn`` / ``prefill`` take it, or
    None for the other families; ``layer_constrain`` goes to each encoder
    block (FSDP's gather), ``tp`` (a ``TPContext``) to each block."""
    if cfg.family != "audio":
        return None
    lc = layer_constrain or tfm._identity
    return lambda p, b: whisper.encode(p, b, cfg, pcfg, layer_constrain=lc, tp=tp)


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
    step's two halves; ``state_to_logical(state)`` the logical state (the
    one-device layout, whole tensors) of a state as the setup holds it,
    ``place_state(logical)`` its inverse, ``leaf_to_logical(i, t)`` /
    ``place_leaf(i, t)`` the same for leaf ``i`` of ``tree_flatten``'s
    order (a checkpoint's); ``state_layout`` how a train setup holds each
    leaf of the state in that order (a ``_Held``: whole, on the host, the
    rows form of a spec, an int8 scale), what ``launch.dryrun`` reads a
    rank's bytes from."""
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
    state_to_logical: Optional[Callable] = None
    place_state: Optional[Callable] = None
    leaf_to_logical: Optional[Callable] = None
    place_leaf: Optional[Callable] = None
    state_layout: Optional[list] = None


def _param_setup(cfg: ModelConfig, pcfg: ParallelConfig, mesh):
    """(ruleset, parameter shapes on the meta device, the axes in the port's
    layout, their specs)."""
    ruleset = Ruleset(mesh, cfg, pcfg)
    param_shapes = tfm.init(None, cfg, dtype=DTYPES[pcfg.param_dtype], device="meta")
    axes = tfm.param_axes(cfg, stacked=False)
    return ruleset, param_shapes, axes, ruleset.param_shardings(axes)


# --------------------------------------------------------------------------
# placement of the parameters
# --------------------------------------------------------------------------

def _leaf_paths(tree, path=""):
    """The path of every leaf in ``tree_flatten``'s order (a module function:
    see ``models.modules.tree_flatten``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{path}/{i}")
    else:
        yield path


def _flat_specs(spec_tree):
    return tree_flatten(spec_tree, is_leaf=lambda x: isinstance(x, tuple))[0]


def _check_divides(param_shapes, specs, mesh, what: str) -> None:
    """A ``ValueError`` naming the first leaf whose sharded dimension does
    not divide over its axes (the JAX package pads a ragged tail; the port
    does not: it pads heads, never a parameter's columns, which the
    flattened ``Hq·hd`` / ``Hkv·hd`` of every configuration divide)."""
    leaves = tree_flatten(param_shapes)[0]
    for path, t, spec in zip(_leaf_paths(param_shapes), leaves, specs):
        try:
            all_blocks(t, spec, mesh)
        except ValueError as e:
            raise ValueError(f"{what}: parameter {path} {tuple(t.shape)} placed by "
                             f"{spec}: {e}") from None


def _gather_tree(tree, specs, gather):
    """``gather(rows, spec)`` of every leaf of a parameter (sub)tree."""
    if isinstance(tree, dict):
        return {k: _gather_tree(v, specs[k], gather) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_gather_tree(v, s, gather) for v, s in zip(tree, specs)]
    return gather(tree, specs)


def _gather_outside(tree, specs, gather):
    """The parameters with every leaf outside the stacks of blocks gathered
    (``embed``, ``final_norm``, ``lm_head``, ``mm_proj``, ``shared_attn``,
    the encoder's ``final_norm``); ``blocks`` and the encoder's ``blocks``
    stay in the rows form, for ``layer_constrain`` to gather one at a time."""
    out = {}
    for k, v in tree.items():
        if k == "blocks":
            out[k] = v
        elif k == "encoder":
            out[k] = _gather_outside(v, specs[k], gather)
        else:
            out[k] = _gather_tree(v, specs[k], gather)
    return out


class _GatherForGrad(torch.autograd.Function):
    """``gather(rows)`` of a rank's block under autograd (``unshard_leaf`` of
    a ``DistMesh`` rank's block; under TP the gather over the data axes
    alone, on either mesh): the forward gathers; the backward hands its
    gradient, this rank's alone and not yet reduced (under TP its model
    block's), to ``sink[key]`` and none to the block.  The setup
    reduce-scatters the sink's gradients after the backward, leaf by leaf,
    in one order on every rank (``gloo`` pairs the messages of equal shape
    in the order the ranks send them)."""

    @staticmethod
    def forward(ctx, rows, gather, sink, key):
        ctx.sink, ctx.key = sink, key
        return gather(rows)

    @staticmethod
    def backward(ctx, g):
        prev = ctx.sink.get(ctx.key)
        ctx.sink[ctx.key] = g if prev is None else prev + g
        return None, None, None, None


def _gather_fn(mesh, sink=None):
    """``gather(rows, spec) -> whole tensor``: ``unshard_leaf`` (on a
    ``StackedMesh`` a view or copy that autograd differentiates; on a
    ``DistMesh`` an all-gather), through ``_GatherForGrad`` on a ``DistMesh``
    when a gradient is taken and ``sink`` collects it."""
    def gather(rows, spec):
        if sink is not None and rows.requires_grad and torch.is_grad_enabled():
            return _GatherForGrad.apply(rows, lambda r: unshard_leaf(r, spec, mesh), sink,
                                        id(rows))
        return unshard_leaf(rows, spec, mesh)
    return gather


def _split_spec(spec, axis: str) -> Tuple[Tuple, Tuple]:
    """(``spec`` without ``axis``, ``spec`` with ``axis`` alone): a leaf's
    placement over the data axes and over the TP axis."""
    spec = tuple(spec)
    return (_spec(tuple(a for a in _names(e) if a != axis) for e in spec),
            _spec(tuple(a for a in _names(e) if a == axis) for e in spec))


def _spec_axes(spec) -> list:
    return [a for e in spec for a in _names(e)]


def _tp_gather_fn(mesh, tp: Optional[str], sink=None, lane: Optional[int] = None,
                  joint=frozenset()):
    """``gather(rows, spec)`` under tensor parallelism over ``tp``: a leaf in
    the rows form of ``spec`` → what the ranks of a TP group compute with:
    the rows form over ``tp`` alone (gathered over the spec's data axes, on a
    ``DistMesh`` by an all-gather over them), or, for a leaf whole over
    ``tp``, the whole tensor.  With ``sink`` a gather over data axes under
    autograd goes through ``_GatherForGrad`` on either mesh, its gradient (the
    rows form over ``tp``) to the sink; a leaf the spec places over ``tp``
    alone takes its gradient in ``.grad``.

    For lane ``lane`` of an expert-parallel group (``tp`` may then be None)
    an expert leaf (its id in ``joint``) comes as it is, the rows form every
    lane of the group computes with (its gradient in ``.grad``); every other
    leaf reaches the lane through ``_GatherForGrad``, also where nothing is
    gathered, its gradient the lane's own in ``sink[(id, lane)]``."""
    def over_data(rows, spec):
        dspec, mspec = _split_spec(spec, tp)
        if not _spec_axes(dspec):
            return rows
        if isinstance(mesh, DistMesh):
            return unshard_leaf(rows, dspec, mesh).unsqueeze(0)
        # a DistMesh rank's all-gather over the data axes brings its model block
        count_stacked(mesh, "all-gather", rows.numel() * rows.element_size() //
                      mesh.size(_spec_axes(mspec)))
        return shard_leaf(unshard_leaf(rows, spec, mesh, count=False), mspec, mesh)

    def gather(rows, spec):
        if id(rows) in joint:
            return rows
        axes = _spec_axes(spec)
        if lane is not None or any(a != tp for a in axes):
            if sink is not None and rows.requires_grad and torch.is_grad_enabled():
                key = id(rows) if lane is None else (id(rows), lane)
                rows = _GatherForGrad.apply(rows, lambda r: over_data(r, spec), sink, key)
            else:
                rows = over_data(rows, spec)
        return rows if tp in axes else rows[0]
    return gather


def make_layer_gather(ruleset: Ruleset, axes_blocks, gather=None):
    """The FSDP hook ``layer_constrain`` of ``models.transformer.loss_fn`` /
    ``prefill`` / ``decode_step`` (and ``models.whisper.encode``): ``f(bp)``
    gathers one block's parameters from the rows form of
    ``make_layer_constrain(ruleset, axes_blocks)``'s specs to whole tensors,
    ``unshard_leaf`` (an all-gather on a ``DistMesh``) unless ``gather(rows,
    spec)`` is given.  Where the JAX closure pins a block to its stored
    sharding, so that XLA gathers inside the layer loop, this gathers."""
    specs = make_layer_constrain(ruleset, axes_blocks)
    gather = gather or _gather_fn(ruleset.mesh)
    return lambda bp: _gather_tree(bp, specs, gather)


def _expert_leaves(cfg: ModelConfig):
    """For every parameter leaf in ``tree_flatten``'s order, whether it is an
    expert leaf (``expert`` among its logical axes)."""
    return ["expert" in a for a in _flat_specs(tfm.param_axes(cfg, stacked=False))]


def _place_fn(cfg: ModelConfig, pcfg: ParallelConfig, ruleset: Ruleset, spec_tree, tp=None,
              ep=None):
    """``place(params, sink=None, lane=0) -> (tree, layer_constrain,
    enc_fn)``: what ``loss_fn`` / ``prefill`` / ``decode_step`` take.  Under
    FSDP the leaves outside the blocks are gathered once, and each block (the
    encoder's too) by the hook when it runs; otherwise the parameters are
    whole.  Under tensor parallelism (``tp`` a ``TPContext``) or expert
    parallelism (``ep`` an ``EPContext``), every sharding: the same hooks
    with ``_tp_gather_fn``, the ranks' model blocks (under EP lane
    ``lane``'s copies, the expert leaves as they are)."""
    if pcfg.param_sharding != "fsdp" and tp is None and ep is None:
        return lambda params, sink=None, lane=0: (params, tfm._identity, _enc_fn(cfg, pcfg))
    axes = tfm.param_axes(cfg)
    mesh = ruleset.mesh

    is_expert = _expert_leaves(cfg)

    def place(params, sink=None, lane=0):
        if tp is None and ep is None:
            gather = _gather_fn(mesh, sink)
        elif ep is None:
            gather = _tp_gather_fn(mesh, tp.axis, sink)
        else:
            joint = frozenset(id(t) for t, e in zip(tree_flatten(params)[0], is_expert) if e)
            gather = _tp_gather_fn(mesh, tp and tp.axis, sink, lane, joint)
        tree = _gather_outside(params, spec_tree, gather)
        lc = make_layer_gather(ruleset, axes["blocks"], gather)
        enc_lc = (make_layer_gather(ruleset, axes["encoder"]["blocks"], gather)
                  if cfg.family == "audio" else None)
        return tree, lc, _enc_fn(cfg, pcfg, enc_lc, tp)
    return place


def _grad_norm(leaves, specs, mesh) -> torch.Tensor:
    """The norm of a synced gradient, fp32: each leaf whole (``specs`` None)
    or in the rows form of its spec.  Every block's sum of squares is taken
    in float64 on its own, then the blocks' sums in rows order (on a
    ``DistMesh`` all-gathered over the spec's axes), then the leaves'.  The
    float64 sums of one gradient held whole or in blocks differ by ~1e-16 of
    their size, so the fp32 norm, and with it the clip factor, is the same
    for the three shardings unless a sum lies that close to an fp32 rounding
    boundary."""
    sums = []
    for i, g in enumerate(leaves):
        spec = None if specs is None else specs[i]
        if spec is None:
            sums.append(torch.sum(torch.square(g.double())))
            continue
        part = torch.stack([torch.sum(torch.square(r.double())) for r in g])
        sums.append(torch.sum(unshard_leaf(part.reshape(-1, *(1 for _ in spec)), spec, mesh)))
    return torch.sqrt(torch.sum(torch.stack(sums))).float()


def _extra_axes(src, dst) -> Tuple:
    """The axes ``dst`` splits each dimension over beyond ``src``'s (which
    must lead its entry): ``dst`` refines ``src``."""
    out = []
    for i, e in enumerate(dst):
        have, names = _names(src[i]) if i < len(src) else (), _names(e)
        if names[:len(have)] != have:
            raise ValueError(f"spec {tuple(dst)} does not refine {tuple(src)}")
        out.append(names[len(have):])
    return _spec(out)


def _refine(rows, src, dst, mesh):
    """A leaf in the rows form of ``src`` → that of ``dst``, which refines
    it (ZeRO-1's optimizer rows from the parameters' under TP): on a
    ``DistMesh`` this rank's piece of its block, no communication."""
    if isinstance(mesh, DistMesh):
        return shard_leaf(rows[0], _extra_axes(src, dst), mesh)
    return shard_leaf(unshard_leaf(rows, src, mesh, count=False), dst, mesh)


def _coarsen(rows, dst, src, mesh):
    """The inverse of ``_refine`` (on a ``DistMesh`` an all-gather over the
    axes ``dst`` adds)."""
    if isinstance(mesh, DistMesh):
        return unshard_leaf(rows, _extra_axes(src, dst), mesh).unsqueeze(0)
    if _spec_axes(_extra_axes(src, dst)):     # a DistMesh rank gathers its src block
        count_stacked(mesh, "all-gather", rows.numel() * rows.element_size() //
                      mesh.size(_spec_axes(src)))
    return shard_leaf(unshard_leaf(rows, dst, mesh, count=False), src, mesh)


def _tp_shard_sync(sync, g, spec, mesh, tp: str):
    """``build_shard_sync``'s ``sync`` of one leaf under TP: ``g`` (replicas,
    R, ...) each replica's gradient in the rows form over ``tp`` (R 1 for a
    leaf whole over it).  Each model block is reduce-scattered over the
    spec's data axes on its own; the blocks are put together in the rows
    form of ``spec``."""
    dspec, _ = _split_spec(spec, tp)
    with in_turns(g.shape[1]):              # each model block's ranks on their own
        per = [sync(all_blocks(g[:, r], (None,) + tuple(dspec), mesh).movedim(0, 1), dspec)
               for r in range(g.shape[1])]
    if len(per) == 1:
        return per[0]
    every = _spec_axes(spec)
    have = [tp] + [a for a in every if a != tp]
    x = torch.stack(per)                        # (model, data rows, ...)
    blk = x.shape[2:]
    x = x.reshape(*(mesh.shape[a] for a in have), *blk)
    x = x.permute(*(have.index(a) for a in every), *range(len(have), len(have) + len(blk)))
    return x.reshape(-1, *blk)


def _row_max_fn(spec, ndim: int, mesh):
    """For an int8 moment in the rows form of ``spec`` (a leaf of ``ndim``
    dims): the function that turns each block's per-row amax into the whole
    row's (the max over the ranks that share the row), or None where the
    leaf's last dim is whole."""
    spec = tuple(spec)
    last = [a for a in (_names(spec[-1]) if len(spec) == ndim else ()) if mesh.shape[a] > 1]
    if not last:
        return None
    if isinstance(mesh, DistMesh):
        def row_max(amax):                     # (1, ...): all-reduce max over `last`
            return mesh.gather(amax.reshape(-1), last).amax(dim=0).reshape(amax.shape)
        return row_max
    every = [a for e in spec for a in _names(e)]
    sizes, pos = [mesh.shape[a] for a in every], [every.index(a) for a in last]

    def row_max(amax):                         # (R, ...): max over the row's blocks
        # a DistMesh rank's all-gather over `last` of its block's amax
        count_stacked(mesh, "all-gather", amax[0].numel() * amax.element_size() *
                      mesh.size(last))
        x = amax.reshape(*sizes, *amax.shape[1:])
        return x.amax(dim=pos, keepdim=True).expand(x.shape).reshape(amax.shape)
    return row_max


class _Held(NamedTuple):
    """How a train setup holds one leaf of the logical state: ``whole`` (on
    the mesh's device), ``host`` (the step counter, on the CPU), ``rows`` (the
    rows form of ``spec``) or ``scale`` (an int8 moment's scale beside its
    ``q`` in the rows form of ``spec``: a rank the scales of its rows, equal
    over the ranks that share a row)."""
    how: str
    spec: Tuple = ()


def _state_layout(param_shapes, specs, opt_specs, ocfg: OptimConfig, held, opt_held):
    """A ``_Held`` for every leaf of the logical ``TrainState``, in
    ``tree_flatten``'s order: the parameters in the rows form of ``specs``
    where ``held``, the master and moments in that of ``opt_specs`` where
    ``opt_held``, else whole."""
    struct = tree_flatten(param_shapes)[1]
    whole = _Held("whole")

    def opt(s):
        return _Held("rows", s) if opt_held else whole

    def moment(s):
        if ocfg.moments_dtype != "int8":
            return opt(s)
        return QTensor(q=opt(s), scale=_Held("scale", s) if opt_held else whole)
    moments = tree_unflatten(struct, [moment(s) for s in opt_specs])
    layout = TrainState(
        params=tree_unflatten(struct, [_Held("rows", s) if held else whole for s in specs]),
        opt=AdamState(step=_Held("host"),
                      master=(tree_unflatten(struct, [opt(s) for s in opt_specs])
                              if ocfg.master else None),
                      m=moments, v=moments))
    return tree_flatten(layout, is_leaf=lambda x: isinstance(x, _Held))[0]


def _scale_split(spec, ndim: int):
    """(the spec of an int8 scale's dimensions, the axes of its ``q``'s last
    dimension) for a ``q`` of ``ndim`` dimensions placed by ``spec``."""
    spec = tuple(spec)
    if len(spec) < ndim:
        return spec, ()
    return spec[:-1], _names(spec[-1])


def _scale_to_logical(rows, spec, mesh):
    """An int8 scale held beside its ``q`` in the rows form of ``spec`` → the
    logical scale (``q.shape[:-1]``): of the blocks over the axes of ``q``'s
    last dimension, equal copies of the whole row's scale, the first (on a
    ``DistMesh`` this rank's), then ``unshard_leaf`` over the rest of the
    spec."""
    lead, last = _scale_split(spec, rows.dim())
    if isinstance(mesh, DistMesh) or not last:
        return unshard_leaf(rows, lead, mesh)
    every = _spec_axes(spec)
    x = rows.reshape(*(mesh.shape[a] for a in every), *rows.shape[1:])
    x = x[tuple(0 if a in last else slice(None) for a in every)]
    return unshard_leaf(x.reshape((-1,) + tuple(rows.shape[1:])), lead, mesh)


def _scale_rows(scale, spec, mesh):
    """The inverse of ``_scale_to_logical``: every rank that holds a piece of
    a row gets the row's scale."""
    lead, last = _scale_split(spec, scale.dim() + 1)
    if not last:
        return shard_leaf(scale, lead, mesh)
    t = scale.unsqueeze(-1).expand(*scale.shape, mesh.size(last))
    return shard_leaf(t, spec, mesh)[..., 0]


# --------------------------------------------------------------------------
# the data-parallel setups
# --------------------------------------------------------------------------

SETUP_SHARDINGS = ("replicated", "zero1", "fsdp")
SETUP_SYNCS = ("flat", "hierarchical")


def _tp_axis(ruleset: Ruleset) -> Optional[str]:
    """The ruleset's TP axis where it has more than one rank, else None."""
    tp = ruleset.tp
    return tp if tp and ruleset.mesh.shape[tp] > 1 else None


def _tp_context(ruleset: Ruleset) -> Optional[TPContext]:
    tp = _tp_axis(ruleset)
    return TPContext(ruleset.mesh, tp) if tp else None


def _ep_context(ruleset: Ruleset, b_axes, what: str) -> Optional[EPContext]:
    """The ruleset's expert parallelism as an ``EPContext``, or None; a
    ``ValueError`` where the EP axis is not the batch's last axis (the lanes
    of a group are then consecutive batch rows) and the sync's inner axis."""
    ep = ruleset.ep_axis
    if not ep:
        return None
    dp = ruleset.dp
    if ep not in dp or not b_axes or b_axes[-1] != ep or dp[-1] != ep:
        raise ValueError(f"{what}: moe_ep_axis={ep!r}: the setups run expert parallelism "
                         f"over the inner data axis that the batch splits over last; the "
                         f"data axes are {dp}, the batch's {b_axes}")
    return EPContext(ruleset.mesh, ep)


def _ep_groups(mesh, n_rows: int, ep: EPContext):
    """The batch rows of each EP group, in order (lane r of group g is row
    g·n + r): every group on a ``StackedMesh``, this rank's row on a
    ``DistMesh``."""
    if isinstance(mesh, DistMesh):
        return [[0]]
    return [list(range(g * ep.size, (g + 1) * ep.size)) for g in range(n_rows // ep.size)]


def _check_mesh(mesh, pcfg, ruleset, what: str) -> None:
    """A ``ValueError`` (``TypeError`` for a foreign mesh) for what no setup
    runs yet."""
    if not isinstance(mesh, (StackedMesh, DistMesh)):
        raise TypeError(f"{what} needs a mesh of launch.mesh, got {type(mesh).__name__}")
    if pcfg.param_sharding not in SETUP_SHARDINGS:
        raise ValueError(f"{what}: param_sharding={pcfg.param_sharding!r}; the setups "
                         f"run {SETUP_SHARDINGS}")
    tp, cfg = _tp_axis(ruleset), ruleset.cfg
    idle = [a for a in mesh.axis_names if mesh.shape[a] > 1 and a not in ruleset.dp
            and a != tp]
    if idle:
        raise ValueError(f"{what}: mesh axes {idle} of more than one rank are neither data "
                         f"axes nor the TP axis {pcfg.tp_axis!r}")
    if tp and cfg.ssm_heads:
        tp_groups(cfg, mesh.shape[tp])          # SSM heads that the ranks cannot split
    if not ruleset.dp:
        raise ValueError(f"{what}: the mesh {mesh.axis_names} has no data axis")


def _sync_axes(cfg, shape, mesh, pcfg, ocfg, ruleset) -> Tuple[str, Optional[str]]:
    """(inner, outer) data axes of the gradient sync; a ``ValueError`` for
    what the setup does not run."""
    if shape.kind != "train":
        raise ValueError(f"make_train_setup: a {shape.kind!r} shape; make_setup sends it "
                         f"to make_{shape.kind}_setup")
    _check_mesh(mesh, pcfg, ruleset, "make_train_setup")
    if pcfg.grad_sync not in SETUP_SYNCS:
        raise ValueError(
            f"make_train_setup: grad_sync={pcfg.grad_sync!r}; the JAX setup's gradient "
            "reduction is exact, and the int8 cross-pod phase of 'compressed' would give "
            f"a different result, not the same one faster: use one of {SETUP_SYNCS}")
    dp = ruleset.dp
    inner = dp[-1]
    # the outer axis: the pod, or without one the data axis before the inner
    # one (no TP: the model axis is more data parallelism after data)
    outer = "pod" if "pod" in dp and inner != "pod" else (dp[-2] if len(dp) == 2 else None)
    extra = [a for a in dp if a not in (inner, outer)]
    if extra:
        raise ValueError(f"make_train_setup: data axes {dp}; the sync reduces over "
                         f"{inner!r} and one outer axis only")
    return inner, outer


def make_train_setup(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     pcfg: Optional[ParallelConfig] = None,
                     ocfg: Optional[OptimConfig] = None) -> CellSetup:
    """The data-parallel train step of one cell over ``mesh`` (a
    ``StackedMesh``: every rank in turn on its device, the gradients stacked
    on a leading rank dimension; a ``DistMesh``: this rank, the others
    through ``torch.distributed``).  ``step_fn(state, batch)`` takes the whole
    batch on every rank, as the JAX step takes the global array.

    ``param_sharding``: ``replicated`` (every rank the whole state),
    ``zero1`` (whole parameters, master and moments in the rows form of
    ``opt_spec``) or ``fsdp`` (parameters, master and moments in the rows
    form of ``spec``; a rank holds its block of each leaf the spec shards;
    each block's parameters gathered right before it runs, ``loss_fn``'s
    ``layer_constrain``; the gradient reduce-scattered to the same rows).
    The synced gradient of ``grad_fn`` is whole (replicated, zero1) or in the
    rows form (fsdp); an int8 moment's ``scale`` is held beside its ``q``,
    each rank the scales of its rows (ranks that share a row hold the same,
    the whole row's)."""
    pcfg = pcfg or ParallelConfig()
    ocfg = ocfg or OptimConfig()
    ruleset, param_shapes, axes, param_shardings = _param_setup(cfg, pcfg, mesh)
    inner, outer = _sync_axes(cfg, shape, mesh, pcfg, ocfg, ruleset)
    sync_axes = tuple(a for a in (outer, inner) if a)
    fsdp = pcfg.param_sharding == "fsdp"
    zero1 = pcfg.param_sharding == "zero1"
    if zero1 and ruleset.ep_axis:
        raise ValueError(
            f"make_train_setup: zero1 with moe_ep_axis={ruleset.ep_axis!r}: opt_spec puts the "
            f"data axis {ruleset.dp[-1]!r} on the experts' embed dim beside their expert dim, "
            f"{ruleset.opt_spec(('expert', 'embed', 'mlp'))}, a duplicated axis (the JAX "
            "setup raises DuplicateSpecError there); use replicated or fsdp")
    tp = _tp_context(ruleset)
    b_axes = ruleset.batch_axes(shape.global_batch) or ()
    n_rows = mesh.size(b_axes)              # distinct shards of the batch
    ep = _ep_context(ruleset, b_axes, "make_train_setup")
    held = fsdp or tp or ep                 # every leaf in the rows form of its spec
    specs = _flat_specs(param_shardings)
    opt_specs = _flat_specs(tree_map(ruleset.opt_spec, axes))
    if zero1 or held:
        _check_divides(param_shapes, opt_specs, mesh, "make_train_setup")
    sync = (build_shard_sync if fsdp else build_sync)(
        mesh, pcfg.grad_sync, inner_axis=inner, outer_axis=outer)
    place = _place_fn(cfg, pcfg, ruleset, param_shardings, tp, ep)
    opt_shardings = opt_state_shardings(ruleset, axes, ocfg)
    shapes = tree_flatten(param_shapes)[0]
    row_max = ([_row_max_fn(s, t.dim(), mesh) for s, t in zip(opt_specs, shapes)]
               if ocfg.moments_dtype == "int8" and (zero1 or held) else None)

    # the batch row of each sync replica (row-major over the sync axes);
    # ranks along a data axis the batch does not divide over share a row
    def batch_row(coords):
        row = 0
        for a in b_axes:
            row = row * mesh.shape[a] + coords[sync_axes.index(a)]
        return row
    replica_coords = list(itertools.product(*(range(mesh.shape[a]) for a in sync_axes)))
    replica_rows = [batch_row(c) for c in replica_coords]
    if ep:
        # an expert leaf's gradient is one EP group's (its lanes' tokens
        # summed), synced over the outer axis alone: the group of each of its
        # replicas, and its mean over them divided by the lanes
        is_expert = _expert_leaves(cfg)
        rest_group = {(c[0] if outer else 0): r // ep.size
                      for c, r in zip(replica_coords, replica_rows)}
        expert_sync = build_sync(mesh, "flat", inner_axis=outer) if outer else None

        def sync_expert(g):
            g = expert_sync(g) if expert_sync else g[0]
            return (g / ep.size).to(g.dtype)

    def init_state(params) -> TrainState:
        """The state for ``params`` (the whole tree): replicated, the tree
        and ``init_adam`` of it; zero1, ``init_adam`` of each leaf's
        ``opt_spec`` rows; fsdp, and every sharding under TP or EP, each
        leaf's ``spec`` rows (a copy: on a ``DistMesh`` this rank's block
        alone) and ``init_adam`` of them (of the ``opt_spec`` rows under
        zero1)."""
        if not (zero1 or held):
            return TrainState(params, init_adam(params, ocfg))
        leaves, spec = tree_flatten(params)
        rows = tree_unflatten(spec, [shard_leaf(p, s, mesh) for p, s in zip(leaves, opt_specs)])
        if held:
            kept = tree_unflatten(spec, [shard_leaf(p, s, mesh).clone()
                                         for p, s in zip(leaves, specs)])
            return TrainState(kept, init_adam(rows if zero1 else kept, ocfg))
        return TrainState(params, init_adam(rows, ocfg))

    def rank_grads(params, batch, weight):
        """One rank's gradient leaves (fsdp: every block of each leaf's rows
        form; under TP the rows form over the TP axis, of a leaf whole over
        it (1, ...)) and metrics."""
        if not (fsdp or tp):
            g, m = train_grads(params, batch, cfg, pcfg, _enc_fn(cfg, pcfg), loss_weight=weight)
            return tree_flatten(g)[0], m
        leaves, spec = tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        sink = {} if isinstance(mesh, DistMesh) or tp else None
        tree, lc, enc_fn = place(tree_unflatten(spec, live), sink)
        batch = batch_to_device(batch, leaves[0].device, leaves[0].dtype)
        total, m = tfm.loss_fn(tree, batch, cfg, pcfg, enc_fn=enc_fn, loss_weight=weight,
                               layer_constrain=lc, tp=tp)
        total.backward()
        del tree, total
        if tp:
            return [sink.pop(id(p)) if id(p) in sink else p.grad for p in live], m
        if sink is None:
            return [p.grad for p in live], m
        return [all_blocks(sink.pop(id(p)), s, mesh) for p, s in zip(live, specs)], m

    def lane_grads(params, batch, weights):
        """The lanes of one EP group together: of each leaf the lanes share,
        every lane's own gradient (lanes, the rows form over the TP axis); of
        each expert leaf, the gradient of its rows (every lane's tokens);
        the metrics (lanes,)."""
        leaves, spec = tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        sink = {}
        tree = tree_unflatten(spec, live)
        lanes = [place(tree, sink, r) for r in range(ep.rows)]
        batch = batch_to_device(batch, leaves[0].device, leaves[0].dtype)
        total, m = tfm.loss_fn([t for t, _, _ in lanes], batch, cfg, pcfg, loss_weight=weights,
                               layer_constrain=[lc for _, lc, _ in lanes], tp=tp, ep=ep)
        total.backward()
        del tree, lanes, total
        return [p.grad if e else torch.stack([sink.pop((id(p), r)) for r in range(ep.rows)])
                for p, e in zip(live, is_expert)], m

    def grad_fn(state: TrainState, batch) -> Tuple[Any, Dict[str, torch.Tensor]]:
        leaves, spec = tree_flatten(state.params)
        batch = batch_to_device(batch, leaves[0].device, leaves[0].dtype)
        placed = {k: shard_leaf(v, (b_axes,), mesh) for k, v in batch.items()}
        labelled = (batch["labels"] >= 0).sum()
        denom = labelled.clamp_min(1).float()
        counts = (placed["labels"] >= 0).flatten(1).sum(1).float()      # (rows,)
        # a rank's mean weighed by its share of the labelled tokens: the
        # mean of the ranks' gradients is the gradient of the global mean
        weights = counts * n_rows / denom
        stacked, part = None, []
        groups = _ep_groups(mesh, n_rows, ep) if ep else []
        for g_i, lanes in enumerate(groups):
            # the EP groups in turn on a StackedMesh, and a group's lanes
            with in_turns(len(groups) * ep.rows):
                g_leaves, m = lane_grads(state.params,
                                         {k: v[lanes] for k, v in placed.items()},
                                         weights[lanes])
            if isinstance(mesh, DistMesh):
                stacked = [t.unsqueeze(0) if e else t for t, e in zip(g_leaves, is_expert)]
            else:
                if stacked is None:     # an expert leaf's by replica of the outer axis
                    stacked = [t.new_empty((len(rest_group),) + tuple(t.shape)) if e else
                               t.new_empty((len(replica_rows),) + tuple(t.shape[1:]))
                               for t, e in zip(g_leaves, is_expert)]
                for buf, t, e in zip(stacked, g_leaves, is_expert):
                    if e:
                        for q in (q for q, g in rest_group.items() if g == g_i):
                            buf[q].copy_(t)
                        continue
                    for i, r in enumerate(replica_rows):
                        if r in lanes:
                            buf[i].copy_(t[lanes.index(r)])
            del g_leaves
            for lane, j in enumerate(lanes):
                part.append(torch.stack([m["loss"][lane] * counts[j], m["aux_loss"][lane]]))
        if ep:
            rows = []
        elif isinstance(mesh, DistMesh):
            rows = [(0, [0])]
        else:
            rows = [(j, [i for i, r in enumerate(replica_rows) if r == j])
                    for j in range(n_rows)]
        for j, replicas in rows:
            with in_turns(len(rows)):       # the batch rows in turn on a StackedMesh
                g_leaves, m = rank_grads(state.params, {k: v[j] for k, v in placed.items()},
                                         weights[j])
            if isinstance(mesh, DistMesh):
                stacked = [t.unsqueeze(0) for t in g_leaves]
            else:
                if stacked is None:
                    stacked = [t.new_empty((len(replica_rows),) + tuple(t.shape))
                               for t in g_leaves]
                for buf, t in zip(stacked, g_leaves):
                    for i in replicas:
                        buf[i].copy_(t)
            del g_leaves
            part.append(torch.stack([m["loss"] * counts[j], m["aux_loss"]]))
        out = []
        for i, s in enumerate(specs):         # each leaf's buffer freed once reduced
            g, stacked[i] = stacked[i], None
            if ep and is_expert[i]:
                out.append(sync_expert(g))
            elif fsdp:
                out.append(_tp_shard_sync(sync, g, s, mesh, tp and tp.axis)
                           if tp or ep else sync(g, s))
            else:       # under TP a replica's row holds its model ranks' blocks
                with of_blocks(g.shape[1] if tp else 1):
                    out.append(sync(g))
        del stacked, g
        synced = tree_unflatten(spec, out)
        # every batch row's (loss x count, aux), row-major over the batch axes
        vals = unshard_leaf(torch.stack(part)[:, None], (b_axes,), mesh)
        metrics = {"loss": vals[:, 0].sum() / denom, "aux_loss": vals[:, 1].mean(),
                   "tokens": denom}
        return synced, metrics

    def update_fn(state: TrainState, grads) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        g_leaves = tree_flatten(grads)[0]
        # the clip factor from the norm of the whole synced gradient
        gnorm = _grad_norm(g_leaves, specs if held else None, mesh)
        if not zero1:
            params, opt, om = adam_update(state.params, grads, state.opt, ocfg, gnorm=gnorm,
                                          row_max=row_max)
            return TrainState(params, opt), om
        leaves, spec = tree_flatten(state.params)
        if tp:              # the parameters and the gradient in the spec's rows form
            p_rows = [_refine(p, s, o, mesh) for p, s, o in zip(leaves, specs, opt_specs)]
            g_rows = [_refine(g, s, o, mesh) for g, s, o in zip(g_leaves, specs, opt_specs)]
            _, opt, om = adam_update(tree_unflatten(spec, p_rows), tree_unflatten(spec, g_rows),
                                     state.opt, ocfg, gnorm=gnorm, row_max=row_max)
            for p, rows, s, o in zip(leaves, p_rows, specs, opt_specs):
                p.copy_(_coarsen(rows, o, s, mesh))
            return TrainState(state.params, opt), om
        p_rows = [shard_leaf(p, s, mesh) for p, s in zip(leaves, opt_specs)]
        g_rows = [shard_leaf(g, s, mesh) for g, s in zip(g_leaves, opt_specs)]
        _, opt, om = adam_update(tree_unflatten(spec, p_rows), tree_unflatten(spec, g_rows),
                                 state.opt, ocfg, gnorm=gnorm, row_max=row_max)
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
    layout = _state_layout(param_shapes, specs, opt_specs, ocfg, held, zero1 or held)
    if len(layout) != len(tree_flatten(state_shapes)[0]):
        raise AssertionError("make_train_setup: the state's layout misses leaves")

    def leaf_to_logical(i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` of the state as held → the logical leaf (a view where
        the leaf is whole; on a ``DistMesh`` an all-gather, so every rank
        takes every leaf, in one order)."""
        how, spec = layout[i]
        if how == "rows":
            return unshard_leaf(t, spec, mesh)
        if how == "scale":
            return _scale_to_logical(t, spec, mesh)
        return t

    def place_leaf(i: int, t: torch.Tensor) -> torch.Tensor:
        """Logical leaf ``i`` (on any device) → the leaf as the setup holds
        it, a new tensor on the mesh's device (the step counter on the CPU);
        on a ``DistMesh`` this rank's block, no communication."""
        how, spec = layout[i]
        if how == "host":
            return t.to("cpu", copy=True)
        if how == "rows":
            t = shard_leaf(t, spec, mesh)
        elif how == "scale":
            t = _scale_rows(t, spec, mesh)
        return t.to(mesh.device, copy=True, memory_format=torch.contiguous_format)

    def state_to_logical(state: TrainState) -> TrainState:
        leaves, struct = tree_flatten(state)
        return tree_unflatten(struct, [leaf_to_logical(i, t) for i, t in enumerate(leaves)])

    def place_state(logical: TrainState) -> TrainState:
        leaves, struct = tree_flatten(logical)
        return tree_unflatten(struct, [place_leaf(i, t) for i, t in enumerate(leaves)])

    return CellSetup(cfg=cfg, pcfg=pcfg, shape=shape, mesh=mesh, ruleset=ruleset,
                     param_shapes=param_shapes, param_shardings=param_shardings,
                     step_fn=step_fn,
                     example_args=(state_shapes, input_specs(cfg, shape, pcfg)),
                     state_shapes=state_shapes,
                     state_shardings=TrainState(params=param_shardings, opt=opt_shardings),
                     init_state=init_state, grad_fn=grad_fn, update_fn=update_fn,
                     state_to_logical=state_to_logical, place_state=place_state,
                     leaf_to_logical=leaf_to_logical, place_leaf=place_leaf,
                     state_layout=layout)


def _kv_seq_context(ruleset: Ruleset, cfg: ModelConfig, shape: ShapeConfig
                    ) -> Optional[KVSeqContext]:
    """The flash-decoding layout of the decode caches where ``kv_cache_spec``
    puts their sequence on axes of more than one rank (KV heads that do not
    divide the TP degree; every axis where no data axis divides the batch),
    with the logical cache length of ``shape``; else None."""
    if cfg.family == "ssm":
        return None
    axes = _names(ruleset.kv_cache_spec(shape.global_batch)[2])
    if ruleset.mesh.size(axes) == 1:
        return None
    return KVSeqContext(ruleset.mesh, axes, tfm._cache_len(cfg, shape.seq_len))


def _serve_setup(cfg, shape, mesh, pcfg, what: str):
    """What the prefill and decode setups share: (pcfg with remat "none",
    ruleset, shapes, specs, batch axes (empty where no data axis divides the
    batch), place, init_state, tp, ep, kv_seq)."""
    pcfg = (pcfg or ParallelConfig()).replace(remat="none")
    ruleset, param_shapes, axes, param_shardings = _param_setup(cfg, pcfg, mesh)
    _check_mesh(mesh, pcfg, ruleset, what)
    tp = _tp_context(ruleset)
    b_axes = ruleset.batch_axes(shape.global_batch) or ()
    ep = _ep_context(ruleset, b_axes, what)
    specs = _flat_specs(param_shardings)
    held = pcfg.param_sharding == "fsdp" or tp or ep
    if held:
        _check_divides(param_shapes, specs, mesh, what)

    def init_state(params):
        """The parameters placed for ``step_fn``: under fsdp, and every
        sharding under TP or EP, each leaf's ``spec`` rows (a copy),
        otherwise ``params`` themselves."""
        if not held:
            return params
        leaves, spec = tree_flatten(params)
        return tree_unflatten(spec, [shard_leaf(p, s, mesh).clone()
                                     for p, s in zip(leaves, specs)])
    return (pcfg, ruleset, param_shapes, param_shardings, b_axes,
            _place_fn(cfg, pcfg, ruleset, param_shardings, tp, ep), init_state, tp, ep,
            _kv_seq_context(ruleset, cfg, shape))


def _batch_rows(mesh, b_axes):
    """The batch rows a call runs: every distinct one on a ``StackedMesh``,
    this rank's on a ``DistMesh`` (one, the whole batch, where ``b_axes`` is
    empty: every data rank runs it, and holds its block of the caches'
    sequence)."""
    return [0] if isinstance(mesh, DistMesh) else range(mesh.size(b_axes))


def _cat_rows(states):
    """One decode state from the states of consecutive batch rows (each
    tensor along its batch dimension, 1)."""
    flat = [tree_flatten(s) for s in states]
    return tree_unflatten(flat[0][1], [torch.cat(ts, dim=1) if torch.is_tensor(ts[0]) else ts[0]
                                       for ts in zip(*(f[0] for f in flat))])


def _row_view(state, j: int, b: int):
    """Batch rows ``j*b .. j*b + b`` of a decode state, views of its
    buffers (a decode step writes through them)."""
    leaves, spec = tree_flatten(state)
    return tree_unflatten(spec, [t.narrow(1, j * b, b) if torch.is_tensor(t) else t
                                 for t in leaves])


def make_prefill_setup(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       pcfg: Optional[ParallelConfig] = None) -> CellSetup:
    """The prefill of one cell over ``mesh``: ``step_fn(params, batch) ->
    (logits (B, V), DecodeState)``, ``params`` as ``init_state`` places them
    (the whole batch on every rank, as the JAX step takes the global array).
    Each rank prefills its rows of the batch (``Ruleset.batch_axes``); the
    logits come back whole, in the batch's order (on a ``DistMesh`` by an
    all-gather), and the decode state in the batch's rows form: every row in
    order on a ``StackedMesh``, this rank's rows on a ``DistMesh``
    (``state_shardings``; under TP the KV heads likewise: every head on a
    ``StackedMesh``, this rank's on a ``DistMesh``; in the flash-decoding
    layout of ``kv_cache_spec`` the blocks of the caches' sequence so, padded
    to a multiple of the ranks).  Remat "none", as in the JAX setup.  Under
    EP the lanes of each EP group prefill together (``tfm.prefill(ep=)``)."""
    what = "make_prefill_setup"
    pcfg, ruleset, param_shapes, param_shardings, b_axes, place, init_state, tp, ep, kv_seq = \
        _serve_setup(cfg, shape, mesh, pcfg, what)
    cache_len = shape.seq_len

    @torch.no_grad()
    def prefill_step(params, batch):
        tree, lc, enc_fn = place(params)
        leaf = tree_flatten(params)[0][0]
        batch = batch_to_device(batch, leaf.device, leaf.dtype)
        placed = {k: shard_leaf(v, (b_axes,), mesh) for k, v in batch.items()}
        logits, states = [], []
        if ep:                  # the lanes of each EP group together
            groups = _ep_groups(mesh, mesh.size(b_axes), ep)
            for rows in groups:
                with in_turns(len(groups) * ep.rows):
                    lg, st = tfm.prefill([tree] * ep.rows,
                                         {k: v[rows] for k, v in placed.items()}, cfg, pcfg,
                                         cache_len, layer_constrain=lc, tp=tp, ep=ep,
                                         kv_seq=kv_seq)
                    logits += [x if tp is None else tp.gather_logits(x) for x in lg]
                states.append(st)
        else:
            rows = _batch_rows(mesh, b_axes)
            for j in rows:
                with in_turns(len(rows)):
                    lg, st = tfm.prefill(tree, {k: v[j] for k, v in placed.items()}, cfg,
                                         pcfg, cache_len, enc_fn=enc_fn, layer_constrain=lc,
                                         tp=tp, kv_seq=kv_seq)
                    logits.append(lg if tp is None else tp.gather_logits(lg))
                states.append(st)
        return unshard_leaf(torch.stack(logits), (b_axes,), mesh), _cat_rows(states)

    return CellSetup(cfg=cfg, pcfg=pcfg, shape=shape, mesh=mesh, ruleset=ruleset,
                     param_shapes=param_shapes, param_shardings=param_shardings,
                     step_fn=prefill_step,
                     example_args=(param_shapes, input_specs(cfg, shape, pcfg)),
                     state_shardings=ruleset.decode_state_shardings(cfg, shape.global_batch),
                     init_state=init_state)


def make_decode_setup(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      pcfg: Optional[ParallelConfig] = None) -> CellSetup:
    """One decode step of one cell over ``mesh``, one new token against a
    cache of ``shape.seq_len``: ``step_fn(params, state, tokens) -> (logits
    (B, V), state)``, tokens (B, 1) whole, the state in the rows form that
    ``make_prefill_setup`` returns.  Each rank steps its rows, writing its
    part of the state in place (``decode_step``); the logits come back whole,
    in the batch's order.  Under EP the lanes of each EP group step
    together.  A cache in the flash-decoding layout (``kv_seq``) is read by
    the combine of every rank's block."""
    what = "make_decode_setup"
    pcfg, ruleset, param_shapes, param_shardings, b_axes, place, init_state, tp, ep, kv_seq = \
        _serve_setup(cfg, shape, mesh, pcfg, what)
    B = shape.global_batch
    cdt = DTYPES[pcfg.compute_dtype]

    @torch.no_grad()
    def decode(params, state, tokens):
        tree, lc, _ = place(params)
        leaf = tree_flatten(params)[0][0]
        tokens = batch_to_device({"tokens": tokens}, leaf.device, leaf.dtype)["tokens"]
        placed = shard_leaf(tokens, (b_axes,), mesh)
        b = placed.shape[1]
        logits = []
        if ep:                  # the lanes of each EP group together
            groups = _ep_groups(mesh, mesh.size(b_axes), ep)
            for g, rows in enumerate(groups):
                sub = state if isinstance(mesh, DistMesh) else _row_view(state, g, ep.rows * b)
                with in_turns(len(groups) * ep.rows):
                    lg = tfm.decode_step([tree] * ep.rows, placed[rows], sub, cfg, pcfg,
                                         layer_constrain=lc, tp=tp, ep=ep, kv_seq=kv_seq)[0]
                    logits += [x if tp is None else tp.gather_logits(x) for x in lg]
        else:
            rows = _batch_rows(mesh, b_axes)
            for j in rows:
                sub = state if isinstance(mesh, DistMesh) else _row_view(state, j, b)
                with in_turns(len(rows)):
                    lg = tfm.decode_step(tree, placed[j], sub, cfg, pcfg, layer_constrain=lc,
                                         tp=tp, kv_seq=kv_seq)[0]
                    logits.append(lg if tp is None else tp.gather_logits(lg))
        return (unshard_leaf(torch.stack(logits), (b_axes,), mesh),
                state._replace(index=state.index + 1))

    state_shapes = tfm.init_decode_state(cfg, B, shape.seq_len, cdt, device="meta")
    toks = torch.empty((B, 1), dtype=torch.int32, device="meta")
    return CellSetup(cfg=cfg, pcfg=pcfg, shape=shape, mesh=mesh, ruleset=ruleset,
                     param_shapes=param_shapes, param_shardings=param_shardings,
                     step_fn=decode, example_args=(param_shapes, state_shapes, toks),
                     state_shapes=state_shapes,
                     state_shardings=ruleset.decode_state_shardings(cfg, B),
                     init_state=init_state)


def decode_state(setup: CellSetup, index: int):
    """A zeroed decode state of a decode setup's cell as its ``step_fn`` takes
    it (the rows form ``make_prefill_setup`` returns: under TP the rows
    form's heads, the flash-decoding layout where ``kv_cache_spec`` asks for
    it; on a ``DistMesh`` this rank's batch rows), on the mesh's device,
    ``index`` tokens seen."""
    cfg, shape, ruleset, mesh = setup.cfg, setup.shape, setup.ruleset, setup.mesh
    B = shape.global_batch
    if isinstance(mesh, DistMesh):
        B //= mesh.size(ruleset.batch_axes(B) or ())
    return tfm._state_buffers(cfg, B, shape.seq_len, DTYPES[setup.pcfg.compute_dtype],
                              mesh.device, _tp_context(ruleset),
                              _kv_seq_context(ruleset, cfg, shape))._replace(index=index)


def make_setup(cfg: ModelConfig, shape: ShapeConfig, mesh,
               pcfg: Optional[ParallelConfig] = None,
               ocfg: Optional[OptimConfig] = None) -> CellSetup:
    """The setup of a cell by its shape's kind: train, prefill or decode."""
    if shape.kind == "train":
        return make_train_setup(cfg, shape, mesh, pcfg, ocfg)
    if shape.kind == "prefill":
        return make_prefill_setup(cfg, shape, mesh, pcfg)
    return make_decode_setup(cfg, shape, mesh, pcfg)


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
