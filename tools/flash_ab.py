#!/usr/bin/env python3
"""The causal (no-window) flash-attention kernels of this tree against those of
another tree (an earlier commit unpacked with ``git archive``), on one card.

    python3 tools/flash_ab.py OTHER_TREE [--rounds N]

Builds ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` of both
trees (each beside its own headers), four nvcc at once, into
``build/flash_ab/``, binds each library in turn in place of this tree's
wrappers (the other tree's entry points may lack the ``window`` argument; a
shim then drops it, which is 0 in every call here) and, in ``--rounds``
rounds of other / this / this / other, times the forward at the prefill
shape of ``chip_smoke.py`` (B 8, S 2048, 32 / 8 heads, hd 64) and the
backward at its training shapes (hd 64 and hd 128), by CUDA events as
``chip_smoke.cuda_ms``.  Then, in the same order, the device time of the
flash kernels (torch.profiler) in one llama3.2-1b prefill (8 x 2048) and in
one llama3.2-1b train step (B 4 x S 2048, block remat), full width and
depth, with the same weights and batch for both.  Prints one JSON line per
measurement and one summary line.  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.train.optim import OptimConfig  # noqa: E402
from repro_torch.train.train_loop import Trainer  # noqa: E402

SOURCES = ("flash_attention", "flash_attention_bwd")
# (C entry, pointers, strides) of each source, as the wrapper binds them
ENTRIES = {"flash_attention": ("flash_attention_fwd", 5, 12),
           "flash_attention_bwd": ("flash_attention_bwd", 10, 24)}


def build_trees(trees):
    """{tag: csrc dir} -> {(tag, source): CDLL}, one nvcc each, in parallel."""
    root = build.build_dir().parent / "flash_ab"
    nvcc, procs = build.find_nvcc(), {}
    for tag, csrc in trees.items():
        d = root / tag
        d.mkdir(parents=True, exist_ok=True)
        for f in [*(csrc / f"{s}.cu" for s in SOURCES), *csrc.glob("*.cuh")]:
            (d / f.name).write_text(f.read_text())
        for s in SOURCES:
            cu = d / f"{s}.cu"
            procs[tag, s] = subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (tag, s), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {tag} {s}:\n{log}")
        libs[tag, s] = ctypes.CDLL(str(root / tag / f"{s}.so"))
    return libs


def takes_window(csrc: Path, source: str) -> bool:
    text = (csrc / f"{source}.cu").read_text()
    head = text[text.index(f'extern "C" int {ENTRIES[source][0]}('):]
    return "int window" in head[:head.index(")")]


def entry(lib, source, with_window):
    """The wrapper's callable for ``lib``: bound as the wrapper binds its own;
    without a window argument in the C entry, a shim drops the wrapper's
    (third from last: ..., causal, window, is_bf16, stream)."""
    name, n_ptr, n_strides = ENTRIES[source]
    fn = getattr(lib, name)
    if with_window:
        return fa._bind(fn, n_ptr, n_strides)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 +
                   [ctypes.c_longlong] * n_strides +
                   [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

    def call(*args):
        if args[-3]:
            raise ValueError("this library takes no window")
        return fn(*args[:-3], *args[-2:])
    return call


def flash_device_ms(by_name):
    fwd = sum(ms for n, ms in by_name.items() if "flash_fwd" in n)
    bwd = sum(ms for n, ms in by_name.items() if "flash_bwd" in n or "bwd_delta" in n)
    return fwd, bwd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="root of the other tree")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    trees = {"other": args.other.resolve() / "src/repro_torch/csrc", "this": build.CSRC}
    libs = build_trees(trees)
    fns = {tag: {s: entry(libs[tag, s], s, takes_window(csrc, s)) for s in SOURCES}
           for tag, csrc in trees.items()}

    def use(tag):
        fa._fn, fa._bwd_fn = fns[tag]["flash_attention"], fns[tag]["flash_attention_bwd"]

    m, t, t128 = cs.MAIN_SHAPE, cs.TRAIN_SHAPE, cs.TRAIN_SHAPE_HD128
    q, k, v = cs.make_qkv(3, m["B"], m["S"], m["S"], m["Hq"], m["Hkv"], m["hd"], m["dtype"], dev)
    calls = {"fwd_hd64_prefill": lambda: fa.flash_attention(q, k, v)}
    outs = {}
    for tag in ("other", "this"):
        use(tag)
        outs[tag] = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    print(json.dumps({"check": "fwd_hd64_prefill", "max_abs_diff_other_vs_this":
                      float((outs["other"].float() - outs["this"].float()).abs().max())}),
          flush=True)
    for name, s in (("bwd_hd64_train", t), ("bwd_hd128_train", t128)):
        tq, tk, tv = cs.make_qkv(27, s["B"], s["S"], s["S"], s["Hq"], s["Hkv"], s["hd"],
                                 s["dtype"], dev)
        tdo = cs.make_qkv(26, s["B"], s["S"], s["S"], s["Hq"], s["Hq"], s["hd"], s["dtype"],
                          dev)[2]
        use("this")
        tout, tlse = fa.flash_attention(tq, tk, tv, return_lse=True)
        # each tree's outputs are bit-equal across calls; their difference
        # between the trees is printed, so that the pair is seen to time the
        # same function
        grads = {}
        for tag in ("other", "this"):
            use(tag)
            grads[tag] = fa.flash_attention_bwd(tq, tk, tv, tout, tdo, tlse)
        torch.cuda.synchronize()
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(grads["other"], grads["this"]))
        print(json.dumps({"check": name, "max_abs_diff_other_vs_this": diff}), flush=True)
        calls[name] = (lambda a=(tq, tk, tv, tout, tdo, tlse): fa.flash_attention_bwd(*a))
    order = ["other", "this", "this", "other"]
    times = {(name, tag): [] for name in calls for tag in trees}
    for r in range(args.rounds):
        for tag in order:
            use(tag)
            for name, call in calls.items():
                ms = cs.cuda_ms(call, warmup=3, reps=15)
                times[name, tag].append(ms)
                print(json.dumps({"round": r, "tree": tag, "kernel": name, "ms": ms}), flush=True)

    # llama3.2-1b at full width and depth: one prefill and one train step
    cfg = get_config("llama3.2-1b")
    B, S = t["B"], t["S"]
    use("this")
    tr = Trainer(cfg, ShapeConfig(f"train_{B}x{S}", "train", S, B),
                 ParallelConfig(remat="block", param_dtype="bfloat16"), OptimConfig(), device=dev)
    box = [tr.init_state()]
    batch = tr.data.batch(0)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (m["B"], m["S"]), generator=gen).to(dev)

    def prefill():
        with torch.inference_mode():
            tfm.prefill(box[0].params, {"tokens": toks}, cfg, None, 4096)

    def step():
        # the same state each time: the step's result is dropped
        _, metrics = tr.step_fn(box[0], batch)
        float(metrics["loss"])
    prof = {(w, tag): [] for w in ("prefill", "train_step") for tag in trees}
    for tag in order:
        use(tag)
        for w, fn in (("prefill", prefill), ("train_step", step)):
            fn()                                             # warm-up
            wall, by_name, _ = cs._device_time_by_kernel(fn)
            fwd, bwd = flash_device_ms(by_name)
            prof[w, tag].append({"wall_ms": wall, "busy_ms": sum(by_name.values()),
                                 "flash_fwd_ms": fwd, "flash_bwd_ms": bwd})
            print(json.dumps({"profile": w, "tree": tag, **prof[w, tag][-1]}), flush=True)
    summary = {name: {tag: {"median_ms": statistics.median(times[name, tag]),
                            "all_ms": times[name, tag]} for tag in trees}
               for name in calls}
    for w in ("prefill", "train_step"):
        summary[w] = {tag: {key: [p[key] for p in prof[w, tag]]
                            for key in ("flash_fwd_ms", "flash_bwd_ms", "busy_ms")}
                      for tag in trees}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"summary": summary, "card": card.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
