#!/usr/bin/env python3
"""Where the bf16 flash-attention and SSD kernels spend their time, by ablation.

    python3 tools/kernel_ablations.py

Builds copies of ``csrc/flash_attention.cu`` and ``csrc/ssd_scan.cu`` with one
part of the work taken out (the results are wrong on purpose), one nvcc each,
all at once, into ``build/ablations/``; binds each in place of the wrapper's
library and times it at ``chip_smoke.py``'s main shapes (llama3.2-1b's
prefill attention, mamba2-1.3b's SSD scan), the unchanged source first, in two
alternating rounds.  Prints one JSON line per variant: median ms of each
round (CUDA events, as ``chip_smoke.cuda_ms``).  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import ctypes
import json
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
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

FLASH_SOFTMAX = "  float ml[4], mh[4];\n"
ABLATIONS = {
    "flash_attention": {
        # P = S rounded to bf16: no max, exp, sum or rescale, the products and loads stay
        "no_softmax": [(FLASH_SOFTMAX,
                        "  corr_lo = corr_hi = 1.f;\n#pragma unroll\n  for (int nt = 0; nt < 16; ++nt) {\n"
                        "    pa[nt >> 1][(nt & 1) * 2] = pack_bf16(sc[4 * nt], sc[4 * nt + 1]);\n"
                        "    pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(sc[4 * nt + 2], sc[4 * nt + 3]);\n"
                        "  }\n  return;\n" + FLASH_SOFTMAX)],
        # 2^x replaced by a multiply
        "no_exp2": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                     "y = x * 0.001f;")],
    },
    "ssd_scan": {
        # every tensor-core product removed: loads, cumsum, exps, splits, stores, barriers
        "no_products": [(ln + "\n", "") for ln in dict.fromkeys(
            ln for ln in (ROOT / "src/repro_torch/csrc/ssd_scan.cu").read_text().splitlines()
            if ln.strip().startswith("mma16816("))],
        # the decay factors of M left out (no 2^x per element of M)
        "no_M_exp2": [("m[nt][e] * ex2(ci - csw[j]) * dts[j]", "m[nt][e] * (ci - csw[j]) * dts[j]")],
    },
}


def variants(name):
    src = (build.CSRC / f"{name}.cu").read_text()
    out = {"unchanged": src}
    for tag, subs in ABLATIONS[name].items():
        text = src
        for a, b in subs:
            if text.count(a) < 1:
                raise SystemExit(f"{name} {tag}: the text to remove is not in the source")
            text = text.replace(a, b)
        out[tag] = text
    return out


def build_all(sources):
    """{(name, tag): source text} -> {(name, tag): CDLL}, one nvcc each, in parallel."""
    d = build.build_dir().parent / "ablations"
    d.mkdir(parents=True, exist_ok=True)
    nvcc, procs = build.find_nvcc(), {}
    for (name, tag), text in sources.items():
        cu = d / f"{name}_{tag}.cu"
        cu.write_text(text)
        procs[name, tag] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(d / f"{key[0]}_{key[1]}.so"))
    return libs


def bind(module, lib, entry):
    """Point ``module``'s wrapper at ``lib`` (same C interface)."""
    module._fn = None
    real = build.load
    build.load = lambda name: lib
    try:
        module._kernel_fn()
    finally:
        build.load = real
    assert getattr(lib, entry) is not None


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablations: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    m = cs.MAIN_SHAPE
    q, k, v = cs.make_qkv(3, m["B"], m["S"], m["S"], m["Hq"], m["Hkv"], m["hd"], m["dtype"], dev)
    cfg = get_config("mamba2-1.3b")
    args = cs.make_ssd(21, 8, 2048, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                       cfg.ssm_groups, torch.bfloat16, dev, served=True, fused=True)
    calls = {"flash_attention": (fa, "flash_attention_fwd", lambda: fa.flash_attention(q, k, v)),
             "ssd_scan": (ssd, "ssd_scan_fwd",
                          lambda: ssd.ssd_scan(*args[:5], return_state=True))}
    sources = {(name, tag): text for name in ABLATIONS for tag, text in variants(name).items()}
    libs = build_all(sources)
    times = {key: [] for key in libs}
    for _ in range(2):
        for (name, tag), lib in libs.items():
            module, entry, call = calls[name]
            bind(module, lib, entry)
            times[name, tag].append(cs.cuda_ms(call, warmup=3, reps=15))
    for name in ABLATIONS:
        calls[name][0]._fn = None            # the wrappers' own libraries again
    for (name, tag), ms in times.items():
        print(json.dumps({"kernel": name, "variant": tag, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
