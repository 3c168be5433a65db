#!/usr/bin/env python3
"""Device memory that a one-device train step leaves held after its
references are dropped, in this tree and, optionally, in another one (an
earlier commit unpacked with ``git archive``), on one card.

    python3 tools/held_memory.py [OTHER_TREE]

For each tree, in a fresh process whose ``repro_torch`` is that tree's:
llama3.2-1b at full width and depth, bf16 parameters, fp32 master and
moments, block remat, one ``make_train_step`` step at B 4 x S 2048, then
``torch.cuda.memory_allocated`` after the step, after dropping the metrics,
after dropping the state and the step function, and after ``gc.collect()``.
Memory that only the collection frees was held by a reference cycle.  The
other tree's kernels are this tree's libraries when its sources are the same
(the build hash covers them), else it builds its own.  Prints one JSON line a
tree.  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import gc, json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ParallelConfig
from repro_torch.parallel.steps import TrainState, make_train_step
from repro_torch.train.optim import OptimConfig, init_adam

dev = torch.device("cuda", 0)
cfg = get_config("llama3.2-1b")
ocfg, pcfg = OptimConfig(), ParallelConfig(remat="block", param_dtype="bfloat16")
rng = np.random.default_rng(0)
toks = rng.integers(0, cfg.vocab_size, (4, 2049))
batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
gb = lambda: torch.cuda.memory_allocated() / 1e9
out = {"tree": sys.argv[1]}
params = tfm.init(0, cfg, dtype=torch.bfloat16, device=dev)
state = TrainState(params, init_adam(params, ocfg))
del params
out["state_gb"] = gb()
step = make_train_step(cfg, pcfg, ocfg)
state, m = step(state, batch)
loss = float(m["loss"])
torch.cuda.synchronize()
out["after_step_gb"] = gb()
del m
out["after_dropping_metrics_gb"] = gb()
del state, step
out["after_dropping_state_gb"] = gb()
out["collected_objects"] = gc.collect()
out["after_gc_collect_gb"] = gb()
out["held_by_cycles_gb"] = out["after_dropping_state_gb"] - out["after_gc_collect_gb"]
out["loss"] = loss
print(json.dumps(out), flush=True)
"""


def run(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tree / "src")],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("held_memory: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    results = [run(ROOT)]
    if len(sys.argv) > 1:
        other = Path(sys.argv[1]).resolve()
        mine, theirs = ROOT / "build" / "repro_torch", other / "build" / "repro_torch"
        theirs.mkdir(parents=True, exist_ok=True)
        for lib in mine.glob("*.so"):
            shutil.copy2(lib, theirs / lib.name)
        results.append(run(other))
    for r in results:
        print(json.dumps({**r, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
