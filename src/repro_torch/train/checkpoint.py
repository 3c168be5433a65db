"""Atomic, async checkpointing of tensor trees.

Counterpart of ``repro.train.checkpoint``, with the same layout (one
directory per step):

    <dir>/step_000420/
        MANIFEST.json        # tree spec, shapes, dtypes, crc32s, extras
        leaf_00000.npy ...   # one file per leaf (quantised moments stored
                             # as their q / scale tensors)
        COMMIT               # written last — a checkpoint without COMMIT
                             # is incomplete and ignored (atomicity)

Fault-tolerance contract, as in the JAX package:
  * writes go to ``step_X.tmp`` then ``rename`` (atomic on POSIX);
  * ``latest_step`` skips uncommitted checkpoints, ``restore`` checks CRCs;
  * ``_retry_io`` retries transient ``OSError``s with exponential backoff;
  * ``cleanup_incomplete`` sweeps ``.tmp`` debris, idempotent under races;
  * ``AsyncCheckpointer`` copies the tensors to host memory (a copy even
    of a CPU tensor, since the train step updates them in place), then
    writes on a background thread — the train loop never blocks on disk; a
    write that failed raises at the next ``wait``.

Differences, and why:
  * bf16 leaves are stored as their raw 16-bit words (``uint16`` .npy) and
    the manifest says so (``"stored_as": "uint16 words of bfloat16"``): numpy
    has no bfloat16 of its own, and the port does not rely on ``ml_dtypes``
    (the JAX package's view type), which the card's machine lacks.
  * ``restore`` writes each stored leaf **into** the target tree's tensor
    (same shape and dtype, or it raises) and returns that tree, so resuming a
    model never holds two copies of its state on the device; a target leaf on
    the meta device (a setup's ``state_shapes``) takes the stored leaf
    itself.  The JAX package places new arrays onto the target's shardings.

Sharded state.  The files hold **logical** leaves in the one-device order
(``models.modules.tree_flatten``), as the JAX package's do, so one
checkpoint restores into the one-device ``Trainer``, onto any mesh and
placement the setups run, and into the JAX package.  A train setup's state
(zero1's or FSDP's rows, a TP rank's model blocks, an EP rank's experts, int8
scales one per rank's row) goes through its ``leaf_to_logical`` on the way
out (``save(to_logical=)``) and its ``place_leaf`` on the way in
(``restore(place=)``), one leaf at a time, so the device holds the state and
one leaf more.  On a ``DistMesh`` (``mesh=``) every rank gathers every leaf,
in leaf order (a collective); the rank whose coordinates are all 0 alone
writes, commits and collects old checkpoints, and then every rank meets at
one all-reduce, which says whether the write failed, so that no rank reads
``latest_step`` before the COMMIT exists.  The directory must be one that
every rank sees (a shared filesystem); a restore reads it on every rank,
each placing its own blocks.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..launch.mesh import DistMesh, any_rank
from ..models.modules import tree_flatten, tree_unflatten

# numpy cannot hold bfloat16: such leaves are stored as their uint16 words
_BF16_STORED_AS = "uint16 words of bfloat16"

# transient-IO retry policy, as the reference: networked filesystems throw
# spurious OSErrors under load; a failed *save* loses a checkpoint and a
# failed *restore* kills a recovery, so both get a few bounded attempts
IO_RETRIES = 3
IO_BACKOFF_S = 0.05     # doubles per attempt


def _retry_io(fn: Callable[[], Any], what: str, *,
              retries: int = IO_RETRIES,
              backoff_s: float = IO_BACKOFF_S) -> Any:
    """Run ``fn`` with bounded retry + exponential backoff on OSError.

    The last attempt re-raises, so persistent failures (disk full, dead
    mount, genuinely missing file) still surface to the caller."""
    for attempt in range(retries):
        try:
            return fn()
        except OSError:
            if attempt == retries - 1:
                raise
            time.sleep(backoff_s * (2 ** attempt))


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, logical dtype) of a tensor or numpy leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.cpu().contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.cpu().numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B")) & 0xFFFFFFFF


def is_writer(mesh=None) -> bool:
    """Whether this process writes a checkpoint of ``mesh``'s state: always
    but on a ``DistMesh``, where the rank whose coordinates are all 0 does."""
    return not isinstance(mesh, DistMesh) or not any(int(c) for c in mesh.coords.values())


def snapshot(tree: Any, to_logical: Optional[Callable[[int, Any], Any]] = None,
             keep: bool = True) -> Any:
    """A copy of ``tree`` in host memory, leaf by leaf (``to_logical(i,
    leaf)`` first, a setup's ``leaf_to_logical``: on a ``DistMesh`` a
    collective, so every rank calls this in the same order).  A copy even of
    a CPU tensor, since the train step updates its tensors in place.  With
    ``keep`` False the leaves are gathered and dropped (a rank that writes
    nothing), and None is returned."""
    leaves, spec = tree_flatten(tree)
    out = []
    for i, t in enumerate(leaves):
        if to_logical is not None:
            t = to_logical(i, t)
        if keep:
            out.append(t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor)
                       else np.array(t))
    return tree_unflatten(spec, out) if keep else None


def _agree_written(mesh, error: Optional[BaseException]) -> None:
    """On a ``DistMesh`` every rank meets here after the writer's COMMIT (or
    its failure): one all-reduce of the failure flag.  The writer re-raises
    its error, the others raise that the write failed."""
    failed = any_rank(mesh, error is not None) if isinstance(mesh, DistMesh) \
        else error is not None
    if error is not None:
        raise error
    if failed:
        raise OSError("the writing rank failed to write the checkpoint")


def save(path: str | Path, tree: Any, *, step: int,
         extras: Optional[Dict[str, Any]] = None,
         to_logical: Optional[Callable[[int, Any], Any]] = None,
         mesh=None) -> Path:
    """Synchronous atomic save.  Returns the committed directory.

    ``to_logical(i, leaf)``: each leaf's logical value (a train setup's
    ``leaf_to_logical``), taken to host memory one leaf at a time.  ``mesh``:
    on a ``DistMesh`` every rank gathers, the writer (``is_writer``) alone
    writes, and every rank returns after the COMMIT."""
    writer = is_writer(mesh)
    if to_logical is not None or not writer:
        tree = snapshot(tree, to_logical, keep=writer)
    error = None
    if writer:
        try:
            _write(path, tree, step=step, extras=extras)
        except Exception as e:                 # every rank must hear of it
            if not isinstance(mesh, DistMesh):
                raise
            error = e
    _agree_written(mesh, error)
    return Path(path) / f"step_{step:08d}"


def _write(path: str | Path, tree: Any, *, step: int,
           extras: Optional[Dict[str, Any]] = None) -> Path:
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves, spec = tree_flatten(tree)
    manifest = {
        "step": step,
        "treedef": repr(spec),
        "n_leaves": len(leaves),
        "leaves": [],
        "extras": extras or {},
    }
    for i, leaf in enumerate(leaves):
        arr, logical_dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        _retry_io(lambda: np.save(tmp / fname, arr, allow_pickle=False),
                  fname)
        meta = {"file": fname, "shape": list(arr.shape), "dtype": logical_dtype,
                "crc32": _crc(arr)}
        if logical_dtype == "bfloat16":
            meta["stored_as"] = _BF16_STORED_AS
        manifest["leaves"].append(meta)
    _retry_io(lambda: (tmp / "MANIFEST.json").write_text(
        json.dumps(manifest, indent=1)), "MANIFEST.json")
    _retry_io(lambda: (tmp / "COMMIT").write_text("ok"), "COMMIT")
    if final.exists():
        shutil.rmtree(final)
    _retry_io(lambda: tmp.rename(final), "commit rename")
    return final


def cleanup_incomplete(path: str | Path) -> int:
    """Remove ``step_X.tmp`` debris left by a writer that died mid-save.
    Committed checkpoints are never touched.  Returns the number of debris
    dirs gone after the call.

    Idempotent under races: two recoveries sweeping the same directory
    concurrently both succeed — a dir the other recovery already removed
    (or the root itself vanishing mid-scan) is a no-op, not an error."""
    root = Path(path)
    try:
        debris = [d for d in root.iterdir()
                  if d.is_dir() and d.name.startswith("step_")
                  and d.name.endswith(".tmp")]
    except FileNotFoundError:
        return 0
    n = 0
    for d in debris:
        shutil.rmtree(d, ignore_errors=True)
        if not d.exists():
            n += 1
    return n


def latest_step(path: str | Path) -> Optional[int]:
    root = Path(path)
    if not root.exists():
        return None
    steps = []
    for d in root.iterdir():
        if d.name.startswith("step_") and not d.name.endswith(".tmp") \
                and (d / "COMMIT").exists():
            try:
                steps.append(int(d.name[5:]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore(path: str | Path, target_tree: Any, *, step: Optional[int] = None,
            verify: bool = True, place: Optional[Callable[[int, torch.Tensor], Any]] = None
            ) -> Tuple[Any, Dict[str, Any]]:
    """Restore into ``target_tree``, a tree of tensors of the checkpoint's
    structure: each stored leaf is copied into the target's tensor in place
    (on its device), and the target tree is returned with the extras.

    ``place(i, leaf)``: the stored (logical) leaf as the target holds it, a
    train setup's ``place_leaf``; then each placed leaf is copied into the
    target's, or, where the target leaf is on the meta device (a setup's
    ``state_shapes``: the logical shapes, nothing allocated), is the
    returned tree's leaf.  Either way the files are read one leaf at a
    time, so the device holds the restored state and one leaf more."""
    root = Path(path)
    step = step if step is not None else latest_step(root)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads(_retry_io(
        lambda: (d / "MANIFEST.json").read_text(), "MANIFEST.json"))

    leaves, spec = tree_flatten(target_tree)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, target expects "
            f"{len(leaves)} — architecture mismatch")
    for i, (meta, leaf) in enumerate(zip(manifest["leaves"], leaves)):
        arr = _retry_io(
            lambda: np.load(d / meta["file"], allow_pickle=False),
            meta["file"])
        if verify and _crc(arr) != meta["crc32"]:
            raise IOError(f"crc mismatch in {meta['file']}")
        t = torch.from_numpy(arr)
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        if leaf.is_meta:
            _check_leaf(i, meta, t, leaf)
            leaves[i] = place(i, t) if place is not None else t
            continue
        if place is not None:
            t = place(i, t)
        _check_leaf(i, meta, t, leaf)
        with torch.no_grad():
            leaf.copy_(t)
        del t
    return tree_unflatten(spec, leaves), manifest["extras"]


def _check_leaf(i: int, meta, t: torch.Tensor, leaf: torch.Tensor) -> None:
    if tuple(t.shape) != tuple(leaf.shape) or t.dtype != leaf.dtype:
        raise ValueError(f"leaf {i} ({meta['file']}): stored {tuple(t.shape)} "
                         f"{t.dtype}, target {tuple(leaf.shape)} {leaf.dtype}")


class AsyncCheckpointer:
    """Snapshot-to-host immediately, write on a worker thread.

    ``mesh``: on a ``DistMesh`` the snapshot (the setup's ``to_logical``, a
    collective) is taken by every rank on the caller's thread, the writer
    alone starts the thread, and ``wait`` is where every rank meets after
    the COMMIT (``save`` waits for the previous write first)."""

    def __init__(self, path: str | Path, keep: int = 3, mesh=None):
        self.path = Path(path)
        self.keep = keep
        self.mesh = mesh
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False
        self.last_committed: Optional[int] = None
        self.last_saved: Optional[int] = None     # the step of the last save called

    def wait(self):
        """Join the writer; a failed write raises here (on a ``DistMesh`` on
        every rank)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        pending, self._pending = self._pending, False
        err, self._error = self._error, None
        if pending and isinstance(self.mesh, DistMesh):
            _agree_written(self.mesh, err)
        elif err is not None:
            raise err

    def save(self, tree: Any, *, step: int,
             extras: Optional[Dict[str, Any]] = None,
             to_logical: Optional[Callable[[int, Any], Any]] = None):
        self.wait()
        writer = is_writer(self.mesh)
        host_tree = snapshot(tree, to_logical, keep=writer)
        self._pending, self.last_saved = True, step
        if not writer:
            return

        def work():
            try:
                _write(self.path, host_tree, step=step, extras=extras)
                self.last_committed = step
                self._gc()
            except BaseException as e:        # handed to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(d.name[5:]) for d in self.path.iterdir()
            if d.name.startswith("step_") and (d / "COMMIT").exists())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.path / f"step_{s:08d}", ignore_errors=True)
