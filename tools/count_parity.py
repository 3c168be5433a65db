#!/usr/bin/env python3
"""The per-device counts of a ``StackedMesh`` against those of a ``DistMesh``.

    python3 tools/count_parity.py [--out FILE]      # the CPU, about ten seconds

Runs the same work over a (pod 1, data 2, model 2) mesh twice: stacked, every
rank in this process, and distributed, one ``gloo`` process a rank (4, a
``file://`` store).  The work: each collective schedule and transport
primitive (``collective_counts``), and one train step, one prefill and one
decode step of four reduced setups (``setup_counts``): llama3.2-1b fsdp with
TP over model, llama3.2-1b zero1 with TP and int8 moments, mixtral-8x7b with
EP over data, mamba2-1.3b fsdp with TP over model.  Prints one JSON object:
for each step the collectives' bytes by kind
(``launch.mesh.count_collectives``, per device) and ``launch.roofline
.count_cost``'s FLOPs and bytes per device, of the stacked run (its count
over the ranks) and of each distributed rank, and their ratio.
``tests/test_torch_launch.py`` runs it and holds the counts to each other.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch.mesh import (DistMesh, StackedMesh, all_to_all,  # noqa: E402
                                     count_collectives, make_dist_mesh, ppermute)
from repro_torch.launch.roofline import count_cost  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.parallel.collectives import (build_shard_sync, flat_all_reduce,  # noqa: E402
                                              hierarchical_all_reduce)
from repro_torch.parallel.sharding import all_blocks  # noqa: E402
from repro_torch.parallel.steps import decode_state, make_setup  # noqa: E402
from repro_torch.parallel.tp import gather_from_tp  # noqa: E402
from repro_torch.train.optim import OptimConfig  # noqa: E402

SHAPE = (1, 2, 2)
AXES = ("pod", "data", "model")
WORLD = 4
N = 48          # values a rank of the all-reduces
# (name, arch, policy, optimizer): fsdp and TP over model; zero1 under TP
# with int8 moments (the optimizer's rows finer than the parameters', and
# the scales' row max); EP over data; the SSM under TP
SETUPS = [("llama3.2-1b", "llama3.2-1b", ParallelConfig(), OptimConfig()),
          ("llama3.2-1b-zero1-int8", "llama3.2-1b", ParallelConfig(param_sharding="zero1"),
           OptimConfig(moments_dtype="int8")),
          ("mixtral-8x7b-ep", "mixtral-8x7b", ParallelConfig(moe_ep_axis="data"), OptimConfig()),
          ("mamba2-1.3b", "mamba2-1.3b", ParallelConfig(), OptimConfig())]
KINDS = ("train", "prefill", "decode")


def collective_counts(mesh):
    """``count_collectives`` of each schedule and primitive on this rank's
    (or every rank's) inputs, forward and backward where it has one."""
    dist = isinstance(mesh, DistMesh)
    lead = () if dist else tuple(mesh.shape.values())
    g = torch.Generator().manual_seed(0)
    x = torch.randn(lead + (N,), generator=g)
    out = {}
    with count_collectives() as c:
        flat_all_reduce(x, mesh, ("pod", "data", "model"))
    out["flat_all_reduce"] = c
    with count_collectives() as c:
        hierarchical_all_reduce(x, mesh, "data", "pod")
    out["hierarchical_all_reduce"] = c
    reps = 1 if dist else mesh.size(("pod", "data"))
    leaf = torch.randn(reps, 4, 6, generator=g)
    spec = ("data", None)
    grads = torch.stack([all_blocks(t, spec, mesh) for t in leaf])
    with count_collectives() as c:
        build_shard_sync(mesh, "hierarchical", "data", "pod")(grads, spec)
    out["build_shard_sync"] = c
    a = torch.randn(mesh.rows(("data",)), mesh.size(("data",)), 3, generator=g).requires_grad_()
    with count_collectives() as c:
        y = all_to_all(mesh, a, ("data",))
        torch.autograd.grad(y, a, torch.ones_like(y))
    out["all_to_all"] = c
    p = torch.randn(mesh.rows(("model",)), 5, generator=g).requires_grad_()
    with count_collectives() as c:
        y = ppermute(mesh, p, "model", 1)
        torch.autograd.grad(y, p, torch.ones_like(y))
    out["ppermute"] = c
    r = torch.randn(mesh.rows(("model",)), 3, 4, generator=g).requires_grad_()
    with count_collectives() as c:
        y = gather_from_tp(r, mesh, "model")
        torch.autograd.grad(y, r, torch.ones_like(y))
    out["gather_from_tp"] = c
    return out


def setup_counts(mesh):
    """Of each of SETUPS' train, prefill and decode steps (B 4 x S 32): the
    collectives and ``count_cost`` per device, ``"<setup>/<kind>"``."""
    ranks = 1 if isinstance(mesh, DistMesh) else mesh.size(mesh.axis_names)
    out = {}
    for name, arch, pcfg, ocfg in SETUPS:
        cfg = get_config(arch).reduced()
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32))
        for kind in KINDS:
            setup = make_setup(cfg, ShapeConfig("t", kind, 32, 4), mesh, pcfg, ocfg)
            params = setup.init_state(tfm.init(0, cfg, dtype=torch.bfloat16, device="cpu"))
            args = {"train": (params, {"tokens": tokens, "labels": tokens}),
                    "prefill": (params, {"tokens": tokens}),
                    "decode": (params, decode_state(setup, 31), tokens[:, :1])}[kind]
            with count_collectives() as c, count_cost(ranks=ranks) as k:
                setup.step_fn(*args)
            out[f"{name}/{kind}"] = {"collectives": c, "flops": k["flops"],
                                     "bytes": k["bytes accessed"]}
    return out


def _rank(rank: int, store: str, out: str) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=WORLD)
    mesh = make_dist_mesh(SHAPE, AXES, device="cpu")
    got = {"primitives": collective_counts(mesh), "setups": setup_counts(mesh)}
    with open(out, "w") as f:
        json.dump(got, f)
    dist.destroy_process_group()


def run(tmpdir: str, timeout: float = 120.0) -> dict:
    """The stacked run here and the gloo world's (one process a rank, one
    time limit for the world): ``{"stacked": ..., "ranks": [...]}``, each
    ``{"primitives", "setups"}``.  A failed rank raises with its errors."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    store = os.path.join(tmpdir, "store")
    outs = [os.path.join(tmpdir, f"rank{r}.json") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               "--store", store, "--rank-out", outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for r in range(WORLD)]
    try:
        mesh = StackedMesh(SHAPE, AXES, "cpu")
        stacked = {"primitives": collective_counts(mesh), "setups": setup_counts(mesh)}
        logs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    bad = [(r, err[-2000:]) for r, (p, (_, err)) in enumerate(zip(procs, logs))
           if p.returncode]
    if bad:
        raise RuntimeError(f"gloo ranks failed: {bad}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    return {"stacked": stacked, "ranks": ranks}


def summary(got: dict) -> dict:
    """Each step's collectives (and whether every rank's equal the stacked
    run's) and its FLOPs and bytes per device: stacked, rank 0, rank 0 over
    stacked."""
    out = {}
    for step, s in got["stacked"]["setups"].items():
        r0 = got["ranks"][0]["setups"][step]
        out[step] = {
            "collectives": s["collectives"],
            "collectives_equal": all(r["setups"][step]["collectives"] == s["collectives"]
                                     for r in got["ranks"]),
            **{k: {"stacked": s[k], "dist_rank": r0[k], "dist_over_stacked": r0[k] / s[k]}
               for k in ("flops", "bytes")}}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON here")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    ap.add_argument("--rank-out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.rank is not None:
        _rank(args.rank, args.store, args.rank_out)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        rec = summary(run(tmp))
    text = json.dumps(rec, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
