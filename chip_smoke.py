#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port starts and is right on a GPU.

    python3 chip_smoke.py                      # every phase, needs one NVIDIA GPU
    python3 chip_smoke.py --phases kernels     # bring-up: build and check only

Drives the port's main path (``repro_torch``: serving llama3.2-1b) through
the entry points a user calls, builds every CUDA kernel from the sources in
this checkout, holds each kernel against its plain PyTorch version on the
card, and shows by the kernels' launch counts that the main path went through
them.  Each phase prints one JSON line; any failure exits non-zero.  Without
a CUDA device the script exits non-zero and prints no result.

Phases:
  env      torch / CUDA versions, the card's name and power limit
  build    nvcc on every ``src/repro_torch/csrc/*.cu`` (all started together)
  kernels  flash_attention against flash_attention_plain: a sweep of small
           shapes and the parity phase's shape, then the serving prefill
           shape (peaked and near-uniform softmax) with timings
  parity   llama3.2-1b at full width, 2 layers, fp32: prefill logits and 4
           decode steps on the card (kernel) against the CPU (plain version)
  serve    llama3.2-1b at full width and depth, bf16: 8 requests through
           ``Engine.run_batch``, twice
  profile  (only when named) device time by kernel over one prefill and four
           decode steps, from torch.profiler

The line before the last is ``{"kernels": [...]}`` (one entry per kernel:
error against the plain version, times, roofline bound, launches on the main
path); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.kernels import build                        # noqa: E402
from repro_torch.kernels.flash_attention import (             # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.models import transformer as tfm            # noqa: E402
from repro_torch.models.modules import tree_map              # noqa: E402
from repro_torch.serve.engine import Engine, EngineConfig, Request  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

PHASES = ("env", "build", "kernels", "parity", "serve")

# the serving prefill shape: 8 requests padded to 2048 tokens of llama3.2-1b
MAIN_SHAPE = dict(B=8, S=2048, Hq=32, Hkv=8, hd=64, dtype=torch.bfloat16,
                  causal=True)
# the reference's sweep (tests/test_kernels.py) as (B, Sq, Sk, Hq, Hkv, hd)
SWEEP = [(1, 64, 64, 1, 1, 64), (2, 128, 128, 4, 4, 64),
         (1, 200, 200, 2, 2, 80), (2, 96, 96, 8, 8, 128),
         (2, 72, 200, 4, 2, 64),        # Sq != Sk, grouped KV heads
         (1, 300, 130, 6, 2, 128),      # Sq > Sk: rows past the last key
         (2, 640, 640, 32, 8, 64)]      # what the parity phase's prefill launches


def tol(dtype):
    """The tolerance the reference's kernel tests use."""
    if dtype == torch.bfloat16:
        return dict(atol=2e-2, rtol=2e-2)
    return dict(atol=2e-5, rtol=2e-4)


# At the serving prefill shape a late row is a near-uniform mean over up to
# 2048 values, so its elements are about 0.02 in size: as small as the sweep's
# bf16 atol.  There the kernel is held to what bf16 rounding alone allows (one
# ulp is at most 2^-7 of the value), and besides to each row's own scale: the
# largest error of a row over the row's rms.  A kv tile left out of a late row
# moves it by some 0.2 of its rms.
MAIN_TOL = dict(atol=1e-3, rtol=2e-2)
MAIN_ROW_REL_TOL = 5e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check_close(name, got, want, atol, rtol):
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
            f"atol={atol} rtol={rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def row_rel_err(got, want):
    """Largest error of a row (the last axis) over that row's rms in ``want``."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(dim=-1)
    rms = want.pow(2).mean(dim=-1).sqrt().clamp_min(1e-30)
    return float((err / rms).max())


def cuda_ms(fn, warmup=2, reps=7):
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def make_qkv(seed, B, Sq, Sk, Hq, Hkv, hd, dtype, device, qk_scale=0.5):
    """q and k at ``qk_scale`` times a unit normal, v a unit normal."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, Sq, Hq, hd), np.float32) * qk_scale)
    k = torch.from_numpy(rng.standard_normal((B, Sk, Hkv, hd), np.float32) * qk_scale)
    v = torch.from_numpy(rng.standard_normal((B, Sk, Hkv, hd), np.float32))
    return tuple(t.to(device=device, dtype=dtype) for t in (q, k, v))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "nvidia_smi_name_power_limit": card})
    return card


def phase_build():
    t0 = time.perf_counter()
    per_source = build.build_all()
    for name in build.sources():
        build.load(name)
    out = {"phase": "build", "sources": build.sources(),
           "seconds": round(time.perf_counter() - t0, 3),
           "nvcc_seconds": {k: round(v, 3) for k, v in per_source.items()}}
    resources = [ln.strip() for log in build.ptxas_log.values()
                 for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    out["ptxas"] = resources
    emit(out)


def phase_kernels(dev):
    """The kernel against its plain version, both on the card."""
    cases = []
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for (B, Sq, Sk, Hq, Hkv, hd) in SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = make_qkv(7, B, Sq, Sk, Hq, Hkv, hd, dtype, dev)
                got = flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                want = flash_attention_plain(q, k, v, causal=causal)
                err = check_close(
                    f"flash_attention {(B, Sq, Sk, Hq, Hkv, hd)} {dtype} causal={causal}",
                    got, want, **tol(dtype))
                worst[dtype] = max(worst[dtype], err)
                cases.append(1)

    # strided inputs: q, k, v as slices of one fused projection
    B, S, Hq, Hkv, hd = 2, 160, 8, 2, 64
    fused = make_qkv(11, B, S, S, Hq + 2 * Hkv, 1, hd, torch.bfloat16, dev)[0]
    q, k, v = fused[:, :, :Hq], fused[:, :, Hq:Hq + Hkv], fused[:, :, Hq + Hkv:]
    err = check_close("flash_attention strided", flash_attention(q, k, v),
                      flash_attention_plain(q, k, v), **tol(torch.bfloat16))
    worst[torch.bfloat16] = max(worst[torch.bfloat16], err)

    # the main path's shape with a peaked softmax: scores of std 4, so a row
    # leans on a few keys, outputs stay O(0.1-1) at every row and the running
    # max is rescaled often
    m = MAIN_SHAPE
    q, k, v = make_qkv(5, m["B"], m["S"], m["S"], m["Hq"], m["Hkv"], m["hd"],
                       m["dtype"], dev, qk_scale=2.0)
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    peaked_err = check_close("flash_attention main shape, peaked softmax",
                             got, want, **tol(m["dtype"]))
    peaked_row_rel = row_rel_err(got, want)
    if peaked_row_rel > MAIN_ROW_REL_TOL:
        raise AssertionError(f"flash_attention main shape, peaked softmax: row error "
                             f"over row rms {peaked_row_rel:.3e} > {MAIN_ROW_REL_TOL}")

    # the main path's shape at the sweep's input scale (near-uniform softmax), timed
    q, k, v = make_qkv(3, m["B"], m["S"], m["S"], m["Hq"], m["Hkv"], m["hd"],
                       m["dtype"], dev)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=True)
    main_err = check_close("flash_attention main shape", got, want, **MAIN_TOL)
    main_row_rel = row_rel_err(got, want)
    if main_row_rel > MAIN_ROW_REL_TOL:
        raise AssertionError(f"flash_attention main shape: row error over row rms "
                             f"{main_row_rel:.3e} > {MAIN_ROW_REL_TOL}")
    kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), warmup=3, reps=15)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True), warmup=1, reps=3)

    # yardstick only: one library call computing the same function
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    rep = m["Hq"] // m["Hkv"]
    kr, vr = kh.repeat_interleave(rep, dim=1), vh.repeat_interleave(rep, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qh, kr, vr, is_causal=True).permute(0, 2, 1, 3)
    check_close("library call vs plain", lib, want, **MAIN_TOL)
    library_ms = cuda_ms(lambda: sdpa(qh, kr, vr, is_causal=True), warmup=3, reps=15)

    # roofline bound of this call: causal halves the products' work
    flops = 2 * 2 * m["B"] * m["Hq"] * m["S"] * m["S"] * m["hd"] / 2
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
    t_ops = flops / PEAK_FLOPS[m["dtype"]] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    entry = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:102",
        "shape": {k_: (str(v_) if k_ == "dtype" else v_) for k_, v_ in m.items()},
        "launches": None,
        "max_abs_err": main_err,
        "tolerance": MAIN_TOL,
        "max_row_err_over_row_rms": main_row_rel,
        "row_err_over_row_rms_limit": MAIN_ROW_REL_TOL,
        "peaked_softmax": {"max_abs_err": peaked_err, "tolerance": tol(m["dtype"]),
                           "max_row_err_over_row_rms": peaked_row_rel},
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "tflops": flops / (kernel_ms * 1e-3) / 1e12,
    }
    emit({"phase": "kernels", "cases": len(cases) + 3,
          "sweep_max_abs_err": {"float32": worst[torch.float32],
                                "bfloat16": worst[torch.bfloat16]},
          "main_shape": entry})
    return entry


def phase_parity(dev):
    """Card (kernel path) against CPU (plain path) on the same weights."""
    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2)
    B, S, steps, cache = 2, 640, 4, 1024
    atol, rtol = 2e-3, 2e-3   # fp32 sums in another order on the two devices
    params = tfm.init(0, cfg, dtype=torch.float32, device=dev)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + steps)))
    errs = []
    with torch.inference_mode():
        before = flash_attention.launches
        lg, st = tfm.prefill(params, {"tokens": toks[:, :S].to(dev)}, cfg, None, cache)
        used = flash_attention.launches - before
        lc, sc = tfm.prefill(params_cpu, {"tokens": toks[:, :S]}, cfg, None, cache)
        if used != cfg.num_layers:
            raise AssertionError(f"parity: prefill launched the kernel {used} times, "
                                 f"expected {cfg.num_layers}")
        if lg.shape != (B, cfg.padded_vocab):
            raise AssertionError(f"parity: logits shape {tuple(lg.shape)}")
        errs.append(check_close("parity prefill logits", lg.cpu(), lc, atol, rtol))
        check_close("parity kv cache", st.kv.k.cpu(), sc.kv.k, atol, rtol)
        for t in range(S, S + steps):
            lg, st = tfm.decode_step(params, toks[:, t:t + 1].to(dev), st, cfg, None)
            lc, sc = tfm.decode_step(params_cpu, toks[:, t:t + 1], sc, cfg, None)
            errs.append(check_close(f"parity decode step {t - S}", lg.cpu(), lc, atol, rtol))
    emit({"phase": "parity", "config": "llama3.2-1b full width, 2 layers, fp32",
          "batch": B, "prompt": S, "decode_steps": steps, "atol": atol, "rtol": rtol,
          "max_abs_err": max(errs), "logit_abs_max": float(lc.abs().max())})


def phase_serve(dev, new_tokens=32):
    cfg = get_config("llama3.2-1b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = tfm.init(gen, cfg, dtype=torch.bfloat16, device=dev)
    n_params = sum(t.numel() for t in [params["embed"], params["final_norm"]]
                   + [w for bp in params["blocks"]
                      for grp in (bp, bp["attn"], bp["ffn"])
                      for w in grp.values() if isinstance(w, torch.Tensor)])
    eng = Engine(params, cfg, ecfg=EngineConfig(max_batch=8, cache_len=4096), device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(1024, 2049, 8)
    lens[0] = 2048           # the batch is padded to the published prefill length
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]

    def requests():
        return [Request(uid=i, prompt=p, max_new_tokens=new_tokens,
                        temperature=0.0 if i % 2 == 0 else 0.8,
                        top_k=0 if i % 2 == 0 else 20)
                for i, p in enumerate(prompts)]

    runs = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0          # counts of the main path only
        done = eng.run_batch(requests(), seed=0)
        launches = flash_attention.launches
        for r in done:
            if len(r.output) != new_tokens or \
                    not all(0 <= t < cfg.vocab_size for t in r.output):
                raise AssertionError(f"serve: request {r.uid} gave {r.output}")
        if eng.nonfinite_logit_rows:
            raise AssertionError(f"serve: {eng.nonfinite_logit_rows} non-finite logit rows")
        if launches != cfg.num_layers:
            raise AssertionError(f"serve: the kernel was launched {launches} times in one "
                                 f"served batch, expected {cfg.num_layers}")
        steps = eng.decode_step_s
        runs.append({
            "outputs": [r.output for r in done],
            "launches": launches,
            "prefill_ms": eng.prefill_s * 1e3,
            "decode_first_step_ms": steps[0] * 1e3,
            "decode_step_ms_p50": statistics.median(steps[1:]) * 1e3,
            "decode_step_ms_max": max(steps[1:]) * 1e3,
            "batch_latency_s": done[0].latency_s,
            "tokens_per_s": sum(len(r.output) for r in done) / done[0].latency_s,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        })
    greedy = [i for i in range(8) if i % 2 == 0]
    if [runs[0]["outputs"][i] for i in greedy] != [runs[1]["outputs"][i] for i in greedy]:
        raise AssertionError("serve: greedy tokens differ between two runs")
    if runs[0]["outputs"] != runs[1]["outputs"]:
        raise AssertionError("serve: sampled tokens differ under the same seed")
    emit({"phase": "serve", "config": cfg.name, "layers": cfg.num_layers,
          "dtype": "bfloat16", "parameters": n_params, "requests": 8,
          "prompt_lengths": [int(n) for n in lens], "new_tokens": new_tokens,
          "cache_len": 4096,
          "first_run": {k: v for k, v in runs[0].items() if k != "outputs"},
          "second_run": {k: v for k, v in runs[1].items() if k != "outputs"}})
    return runs[1]["launches"]


def _device_time_by_kernel(fn):
    """Run ``fn`` under torch.profiler; (wall ms, {kernel name: device ms})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return wall_ms, by_name


def _summarise(wall_ms, by_name):
    groups = {"flash_attention kernel": 0.0, "matrix products (library)": 0.0,
              "copies": 0.0, "elementwise and other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        if "flash_fwd" in low:
            groups["flash_attention kernel"] += ms
        elif any(w in low for w in ("gemm", "gemv", "cutlass", "nvjet", "xmma", "cublas")):
            groups["matrix products (library)"] += ms
        elif "memcpy" in low or "memset" in low:
            groups["copies"] += ms
        else:
            groups["elementwise and other"] += ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms else None,
            "groups_ms": groups,
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def phase_profile(dev):
    """Optional (``--phases profile``): where one prefill and four decode
    steps of the serve phase's model spend their device time."""
    cfg = get_config("llama3.2-1b")
    params = tfm.init(0, cfg, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 2048))).to(dev)
    nxt = toks[:, :1]
    with torch.inference_mode():
        _, st = tfm.prefill(params, {"tokens": toks}, cfg, None, 4096)   # warm-up
        for _ in range(2):
            _, st = tfm.decode_step(params, nxt, st, cfg, None)
        pre = _summarise(*_device_time_by_kernel(
            lambda: tfm.prefill(params, {"tokens": toks}, cfg, None, 4096)))
        state = [st]

        def four_steps():
            for _ in range(4):
                _, state[0] = tfm.decode_step(params, nxt, state[0], cfg, None)
        dec = _summarise(*_device_time_by_kernel(four_steps))
    emit({"phase": "profile", "config": cfg.name, "batch": 8, "prompt": 2048,
          "prefill": pre, "decode_4_steps": dec})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - {"profile"}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    card = phase_env()
    phase_build()         # every later phase needs the kernels
    entry = phase_kernels(dev) if "kernels" in phases else None
    if "parity" in phases:
        phase_parity(dev)
    launches = phase_serve(dev) if "serve" in phases else None
    if "profile" in phases:
        phase_profile(dev)

    full = set(PHASES) <= set(phases)
    if entry is not None:
        entry["launches"] = launches
        entry["card"] = card
    print(card, flush=True)
    emit({"kernels": [entry] if entry is not None else []})
    if not full:
        # a partial run is for bring-up; only a full run may report success
        emit({"ok": False, "partial": phases})
        return 0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
