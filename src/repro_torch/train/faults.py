"""Fault injection for the train loop.

Counterpart of ``repro.train.faults``: it *creates* the failures that the
recovery path (torn checkpoint swept, survivors re-meshed, state placed
again, trajectory continued) must survive, so that the path is exercised end
to end by the tests and by ``chip_smoke.py``.

Three injectors:

  * :func:`torn_save` — a checkpoint writer killed mid-save: real leaf files
    (logical leaves, as ``checkpoint.save`` writes them) land in the
    ``step_X.tmp`` staging directory but the MANIFEST / COMMIT never do.
    The debris is what ``checkpoint.cleanup_incomplete`` must sweep and
    ``latest_step`` must ignore.
  * :class:`FlakyIO` — a transient-failure wrapper (NFS/FUSE under load): the
    first ``failures`` calls raise ``OSError``, then it delegates.  This is
    the fault ``checkpoint._retry_io`` exists to absorb.
  * :func:`seeded_device_failure` — a seeded draw of ranks to kill, with the
    JAX package's ``random.Random(seed)``: the same positions of the mesh's
    row-major order as its draw over ``mesh.devices.flat``.

:func:`crash_and_recover` composes them into the full story: tear the
in-flight save, kill ranks, and drive ``elastic.resume_after_failure`` —
including the ``n_alive < tp`` case where the survivors cannot host the
model axis and ``plan_shrink`` re-plans ``tp`` onto a smaller divisor.
Ranks are positions (``elastic``'s docstring says why); a ``DistMesh`` is
refused by ``elastic.shrink_mesh``.
"""

from __future__ import annotations

import dataclasses
import random
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..models.config import ModelConfig, ParallelConfig, ShapeConfig
from ..models.modules import tree_flatten
from ..parallel.steps import make_train_setup
from . import checkpoint as ckpt
from .elastic import resume_after_failure
from .optim import OptimConfig


class TornWrite(RuntimeError):
    """Raised by :func:`torn_save` at the simulated point of death."""


def torn_save(path: str | Path, tree: Any, *, step: int, fail_after_leaves: int = 1,
              to_logical: Optional[Callable[[int, Any], Any]] = None) -> Path:
    """Start a real checkpoint save and die partway through.

    Writes ``fail_after_leaves`` genuine leaf ``.npy`` files (each leaf
    through ``to_logical(i, leaf)`` first, a setup's ``leaf_to_logical``,
    as ``checkpoint.save`` takes it) into the ``step_X.tmp`` staging
    directory — never the manifest, never the COMMIT marker, never the
    rename — then raises :class:`TornWrite`, exactly as if the writer
    process was killed by the failure the checkpoint was racing.  Returns
    nothing usable: the point is the debris left behind (the raised
    exception carries the tmp path)."""
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, _ = tree_flatten(tree)
    n = min(fail_after_leaves, len(leaves))
    for i, leaf in enumerate(leaves[:n]):
        if to_logical is not None:
            leaf = to_logical(i, leaf)
        np.save(tmp / f"leaf_{i:05d}.npy", ckpt._to_numpy(leaf)[0], allow_pickle=False)
    raise TornWrite(
        f"simulated writer death after {n}/{len(leaves)} leaves in {tmp}")


class FlakyIO:
    """Wrap a callable so its first ``failures`` invocations raise
    ``OSError`` (the transient NFS/FUSE fault model), then delegate.

    ``calls`` counts every invocation — a retry loop that absorbed two
    injected faults shows ``calls == failures + 1``."""

    def __init__(self, fn: Callable[..., Any], failures: int):
        self.fn = fn
        self.failures_left = failures
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.failures_left > 0:
            self.failures_left -= 1
            raise OSError(f"injected transient IO failure "
                          f"({self.failures_left} left)")
        return self.fn(*args, **kwargs)


def seeded_device_failure(mesh, n_failed: int, seed: int = 0) -> List[int]:
    """A seeded sample of ``mesh``'s ranks to declare dead, as positions in
    its row-major order — the runtime mirror of the cost model's
    degradation-chain kill order (``random.Random(seed)``), so a cost-model
    scenario and its runtime re-enactment can share a seed."""
    n = mesh.size(mesh.axis_names)
    if not 0 < n_failed < n:
        raise ValueError(f"n_failed must be in (0, {n}), got {n_failed}")
    return random.Random(seed).sample(range(n), n_failed)


@dataclasses.dataclass(frozen=True)
class FaultRecovery:
    """What :func:`crash_and_recover` hands back to the train loop."""
    setup: Any                        # CellSetup for the survivor mesh
    state: Any                        # TrainState restored and placed
    resumed_step: int                 # last *committed* step
    mesh: Any                         # the survivor mesh
    failed: Tuple                     # ranks declared dead (positions)
    torn_step: int                    # the save the failure interrupted
    plan: Dict[str, int]              # new mesh axes, e.g. data/model


def crash_and_recover(checkpoint_dir: str | Path, cfg: ModelConfig,
                      shape: ShapeConfig, mesh, state: Any, *,
                      torn_step: int, n_failed: int, seed: int = 0,
                      pcfg: Optional[ParallelConfig] = None,
                      ocfg: Optional[OptimConfig] = None) -> FaultRecovery:
    """Inject the full failure story and recover from it.

    1. the in-flight save of ``torn_step`` (``state`` as ``mesh``'s setup
       holds it) is torn mid-write (:func:`torn_save` — committed
       checkpoints are untouched);
    2. ``n_failed`` seeded ranks die (:func:`seeded_device_failure`);
    3. ``elastic.resume_after_failure`` sweeps the debris, shrinks the mesh
       onto the survivors (re-planning ``tp`` over its divisors when the
       failure ate into the model axis), and restores the last committed
       checkpoint onto the new placement.
    """
    to_logical = make_train_setup(cfg, shape, mesh, pcfg, ocfg).leaf_to_logical
    try:
        torn_save(checkpoint_dir, state, step=torn_step, to_logical=to_logical)
    except TornWrite:
        pass                          # the simulated kill, by design
    failed = seeded_device_failure(mesh, n_failed, seed)
    setup, new_state, at, new_mesh = resume_after_failure(
        str(checkpoint_dir), cfg, shape, mesh, failed, pcfg, ocfg)
    return FaultRecovery(setup=setup, state=new_state, resumed_step=at,
                         mesh=new_mesh, failed=tuple(failed),
                         torn_step=torn_step, plan=dict(new_mesh.shape))
