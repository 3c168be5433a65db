"""Builds the port's CUDA sources, one shared library each, at first use.

No JAX counterpart: Pallas kernels are compiled by XLA, these by ``nvcc``.
Every ``csrc/*.cu`` file has a plain C interface (no PyTorch headers), so a
build takes seconds.  Each source is compiled on its own, all at once, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build dir>/<name>-<hash>.so csrc/<name>.cu

and loaded with ``ctypes``.  The hash covers the source text, the text of
every ``csrc/`` header it includes (``hopper.cuh``) and the flags, so an
edited source or header is rebuilt and a stale library is never loaded.  The
build directory is ``build/repro_torch`` under the repository root (git
ignores it).

Nothing here runs at import time, and nothing falls back: without ``nvcc``,
or when a source does not compile, ``load`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_INCLUDE = r'^\s*#\s*include\s+"([^"]+)"'   # a local header: #include "x.cuh"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# what the last build of each source printed (registers, shared memory, spills)
ptxas_log: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def build_dir() -> Path:
    # src/repro_torch/kernels/build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH, "
        "/usr/local/cuda): the CUDA kernels of repro_torch cannot be built")


def sources() -> List[str]:
    """Names (without suffix) of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _included(src: Path) -> List[Path]:
    """The headers of ``csrc/`` that ``src`` includes (``#include "x.cuh"``),
    and theirs, each once."""
    seen: List[Path] = []
    todo = [src]
    while todo:
        for name in re.findall(_INCLUDE, todo.pop().read_text(), re.M):
            path = src.parent / name
            if path.exists() and path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for header in _included(src):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


class _Job:
    """One running nvcc."""

    def __init__(self, name: str, nvcc: str):
        self.name = name
        self.out = _target(name)
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self.tmp = self.out.with_suffix(f".{os.getpid()}.tmp")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(self.tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(self) -> None:
        log, _ = self.proc.communicate()
        build_seconds[self.name] = time.perf_counter() - self.t0
        ptxas_log[self.name] = log
        if self.proc.returncode != 0:
            self.tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{self.name}.cu "
                               f"(exit {self.proc.returncode}):\n{log}")
        os.replace(self.tmp, self.out)                # atomic: no torn library


def build_all() -> Dict[str, float]:
    """Build every source that is not built yet, one nvcc each, all started
    together.  Returns the seconds each build took (empty if all were
    cached)."""
    with _lock:
        todo = [n for n in sources() if not _target(n).exists()]
        if not todo:
            return {}
        nvcc = find_nvcc()
        jobs = [_Job(n, nvcc) for n in todo]
        failed = []
        for job in jobs:                  # wait for every nvcc, even after a failure
            try:
                job.finish()
            except RuntimeError as e:
                failed.append(e)
        if failed:
            raise failed[0]
        return {n: build_seconds[n] for n in todo}


def batch3(shape: Sequence[int], *strides: Sequence[int], what: str
           ) -> Tuple[List[int], ...]:
    """Leading (batch) dimensions as the kernels' C interfaces take them:
    exactly three sizes, and three element strides for each tensor that is
    indexed by the same batch.  Dimensions of size 1 are dropped and
    neighbours that index every tensor's memory as one dimension are merged,
    so any view whose batch dimensions reduce to three or fewer is read in
    place; more raises.  Returns ``(sizes, strides_1, strides_2, ...)``,
    padded at the front with size 1, stride 0."""
    dims = [(n, list(s)) for n, *s in zip(shape, *strides) if n != 1]
    merged: List[Tuple[int, List[int]]] = []
    for n, st in dims:
        if merged and all(a == b * n for a, b in zip(merged[-1][1], st)):
            merged[-1] = (merged[-1][0] * n, st)
        else:
            merged.append((n, st))
    if len(merged) > 3:
        raise ValueError(f"{what}: batch dimensions {tuple(shape)} with strides "
                         f"{[tuple(s) for s in strides]} do not reduce to three")
    merged = [(1, [0] * len(strides))] * (3 - len(merged)) + merged
    return ([n for n, _ in merged],
            *([st[i] for _, st in merged] for i in range(len(strides))))


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if not (CSRC / f"{name}.cu").exists():
                raise FileNotFoundError(f"no kernel source csrc/{name}.cu")
            if not _target(name).exists():
                _Job(name, find_nvcc()).finish()
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
