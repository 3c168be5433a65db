"""Elastic scaling: resume a run on another mesh.

Counterpart of ``repro.train.elastic``.  Checkpoints hold *logical* (whole)
leaves (``train.checkpoint``), so elasticity is a restore-time concern: build
the new mesh's setup from the same rules and place each stored leaf as that
setup holds it (``CellSetup.place_leaf``).  The batch's divisibility is
checked again; the optimizer state and the step counter do not depend on the
mesh.

On a failure the surviving ranks become the largest mesh that still runs
(:func:`shrink_mesh`: the model axis is kept, the data-parallel degree
drops), and :func:`resume_after_failure` restores the last committed
checkpoint onto it.  Growing back later is the same path with more ranks.

Differences from the JAX package, and why:
  * A failure names ranks by their position in the mesh's row-major order
    (the JAX package names devices).  On a ``StackedMesh`` every rank lives on
    one device, so the shrunk mesh is a ``StackedMesh`` on that device whose
    ``ranks`` record which of the old ranks its ranks are; nothing moves.
  * :func:`shrink_mesh` refuses a ``DistMesh`` with a ``ValueError``: its
    ranks are processes, and the survivors go on as a new world of ``data x
    model`` processes (``torch.distributed.init_process_group`` with that
    size) that each call :func:`resume_on_mesh` on a ``DistMesh`` of it.
  * :func:`resume_on_mesh` builds the placed state leaf by leaf from the
    files (``checkpoint.restore`` into the setup's ``state_shapes``, which
    are on the meta device): no parameters are drawn first, and the device
    holds the restored state and one leaf more.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Tuple

from ..core.placement import Strategy
from ..core.workloads import MemoryModel, from_model_config, is_feasible
from ..launch.mesh import DistMesh, StackedMesh
from ..models.config import ModelConfig, ParallelConfig, ShapeConfig
from ..parallel.steps import CellSetup, make_train_setup
from . import checkpoint as ckpt
from .optim import OptimConfig


def validate_shape_for_mesh(shape: ShapeConfig, mesh) -> None:
    """Reject (shape, mesh) pairs the step builders cannot tile.

    The global batch must split evenly over *every* batch-sharded mesh
    axis — ``data``, plus ``pod`` on multi-pod meshes where the gradient
    sync spans both (``parallel.collectives.build_sync``).  A mesh with
    more batch shards than samples fails the same test (the remainder is
    the whole batch)."""
    shards = 1
    for axis in ("pod", "data"):
        shards *= mesh.shape.get(axis, 1)
    if shape.global_batch % shards:
        raise ValueError(
            f"global batch {shape.global_batch} not divisible by the "
            f"{shards} batch shards of the new mesh "
            f"(axes {dict(mesh.shape)})")


def _best_dp(n_alive: int, tp: int, global_batch: int) -> int:
    """Largest DP degree that fits the survivors and divides the batch."""
    dp = n_alive // tp
    while dp > 1 and global_batch % dp:
        dp -= 1
    return dp


def plan_shrink(n_alive: int, tp: int, global_batch: int, *,
                model_cfg: Optional[ModelConfig] = None,
                shape: Optional[ShapeConfig] = None,
                npu_hbm_bytes: Optional[float] = None) -> Tuple[int, int]:
    """Largest ``(data, model)`` logical shape on ``n_alive`` ranks.

    While ``n_alive >= tp`` the model axis is kept at ``tp`` and the DP
    degree is the largest value that both fits the survivors and divides the
    global batch.  When the failure eats into the model axis itself
    (``n_alive < tp``) and ``model_cfg`` is given, the model axis is
    re-planned over the divisors of ``tp`` (largest first): a candidate
    ``tp'`` must divide the query heads, KV heads and FFN width, and — when
    ``shape`` and ``npu_hbm_bytes`` are also given — the resharded model must
    still fit one device's memory under the cost model's
    :class:`~repro_torch.core.workloads.MemoryModel`.  Without ``model_cfg``
    there is nothing safe to re-plan against and the shrink fails."""
    if tp < 1:
        raise ValueError(f"model axis must be ≥ 1, got tp={tp}")
    if n_alive < 1:
        raise ValueError(f"no surviving devices (n_alive={n_alive})")
    if n_alive >= tp:
        return _best_dp(n_alive, tp, global_batch), tp
    if model_cfg is None:
        raise ValueError(
            f"{n_alive} surviving devices cannot host the model axis of "
            f"{tp} — pass model_cfg to re-plan tp over its divisors, or "
            f"restore onto repaired hardware")
    rejected = []
    for cand in (d for d in range(min(tp - 1, n_alive), 0, -1)
                 if tp % d == 0):
        if (model_cfg.n_heads % cand or model_cfg.n_kv_heads % cand
                or model_cfg.d_ff % cand):
            rejected.append(f"tp={cand}: heads/FFN not divisible")
            continue
        dp = _best_dp(n_alive, cand, global_batch)
        if shape is not None and npu_hbm_bytes is not None:
            w = from_model_config(model_cfg, shape, Strategy(mp=cand, dp=dp, pp=1))
            if not is_feasible(w, MemoryModel(npu_hbm_bytes=npu_hbm_bytes)):
                rejected.append(f"tp={cand}: exceeds per-NPU memory")
                continue
        return dp, cand
    detail = "; ".join(rejected) if rejected else "no divisor fits"
    raise ValueError(
        f"{n_alive} surviving devices cannot host the model axis of "
        f"{tp} and no smaller divisor works ({detail})")


def shrink_mesh(mesh, failed: Iterable[int], shape: ShapeConfig,
                cfg: Optional[ModelConfig] = None,
                npu_hbm_bytes: Optional[float] = None) -> StackedMesh:
    """The largest valid ``(data, model)`` mesh on the ranks surviving
    ``failed`` (positions in ``mesh``'s row-major order; duplicates are
    dropped before filtering, so a doubly reported failure is one failure).

    The survivors keep their order, so DP replica 0 stays where it was
    whenever it survived.  The result is a ``StackedMesh`` on ``mesh``'s
    device; its ``ranks`` say which rank of the original mesh each of its
    ranks is.  With ``cfg`` a failure that eats into the model axis re-plans
    ``tp`` over its valid divisors instead of failing, each held to
    ``npu_hbm_bytes`` when it is given (see :func:`plan_shrink`).  A ``DistMesh`` is refused (see the module's
    docstring)."""
    if isinstance(mesh, DistMesh):
        raise ValueError(
            "shrink_mesh: the ranks of a DistMesh are processes; relaunch the survivors as a "
            "world of data x model processes and call resume_on_mesh there")
    n = mesh.size(mesh.axis_names)
    failed = frozenset(dict.fromkeys(int(r) for r in failed))
    if any(not 0 <= r < n for r in failed):
        raise ValueError(f"failed ranks {sorted(failed)} are not positions of a mesh of {n}")
    alive = [r for r in range(n) if r not in failed]
    tp = mesh.shape.get("model", 1)
    dp, tp = plan_shrink(len(alive), tp, shape.global_batch,
                         model_cfg=cfg, shape=shape, npu_hbm_bytes=npu_hbm_bytes)
    return StackedMesh((dp, tp), ("data", "model"), mesh.device,
                       ranks=[mesh.ranks[r] for r in alive[:dp * tp]])


def resume_on_mesh(checkpoint_dir: str, cfg: ModelConfig, shape: ShapeConfig,
                   new_mesh, pcfg: Optional[ParallelConfig] = None,
                   ocfg: Optional[OptimConfig] = None,
                   step: Optional[int] = None) -> Tuple[CellSetup, Any, int]:
    """Build the setup for ``new_mesh`` and restore state onto it.

    Returns (setup, train_state, resumed_step).  Stale ``.tmp`` debris
    from a save interrupted by the failure is swept first — only
    committed checkpoints are ever restored.  On a ``DistMesh`` every rank
    calls this and places its own blocks."""
    validate_shape_for_mesh(shape, new_mesh)
    ckpt.cleanup_incomplete(checkpoint_dir)
    setup = make_train_setup(cfg, shape, new_mesh, pcfg, ocfg)
    state, extras = ckpt.restore(checkpoint_dir, setup.state_shapes, step=step,
                                 place=setup.place_leaf)
    return setup, state, int(extras.get("step", 0))


def resume_after_failure(checkpoint_dir: str, cfg: ModelConfig,
                         shape: ShapeConfig, mesh, failed: Iterable[int],
                         pcfg: Optional[ParallelConfig] = None,
                         ocfg: Optional[OptimConfig] = None,
                         step: Optional[int] = None
                         ) -> Tuple[CellSetup, Any, int, StackedMesh]:
    """One-call failure recovery: shrink, re-shard, resume.

    ``failed`` lists the dead ranks of ``mesh``; the survivors become the
    largest still-valid ``(data, model)`` mesh and the last committed
    checkpoint is restored onto it.  Returns (setup, train_state,
    resumed_step, new_mesh) — the caller re-enters its train loop on
    ``new_mesh`` with the DP degree dropped, or — when the failure ate into
    the model axis — with ``tp`` re-planned onto a smaller head/FFN-divisible
    divisor."""
    new_mesh = shrink_mesh(mesh, failed, shape, cfg=cfg)
    setup, state, at = resume_on_mesh(checkpoint_dir, cfg, shape, new_mesh,
                                      pcfg, ocfg, step=step)
    return setup, state, at, new_mesh
