#!/usr/bin/env python3
"""Where the bf16 flash-attention and SSD kernels (forward and backward) spend
their time, by ablation.

    python3 tools/kernel_ablations.py

Builds copies of ``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``,
``csrc/ssd_scan.cu`` and ``csrc/ssd_scan_bwd.cu`` with one part of the work
taken out (the results are wrong on purpose), one nvcc each, all at once,
into ``build/ablations/`` (each copy beside its own copies of the headers of
``csrc/``, which a variant may change too); binds each in place of
the wrapper's library and times it at ``chip_smoke.py``'s main shapes
(llama3.2-1b's prefill attention, its training shape's attention backward,
mamba2-1.3b's SSD scan at its serving shape and its backward at its training
shape), the unchanged source first, in two alternating rounds.  Prints one
JSON line per variant: median ms of each round (CUDA events, as
``chip_smoke.cuda_ms``).  Needs one NVIDIA GPU.
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
# the bf16 SSD chains' write of a chunk's carry (hi and lo planes staged in
# shared memory, 16-byte stores contiguous across the block), and the first
# version's stores straight from the fragments
SSD_BWD_COPY_OUT = """      for (int i = tid; i < 2 * HD * CPR; i += 256) {
        const int lo = i / (HD * CPR), r = (i / CPR) % HD, cc = i % CPR;
        *reinterpret_cast<uint4*>(o + lo * HD * N + r * N + cc * 8) =
            *reinterpret_cast<const uint4*>((lo ? stl : sth) + r * LDN + cc * 8);
      }
"""
SSD_BWD_FRAGMENT_STORES = """      if (owns)
        for (int k = 0; k < TPW; ++k) {
          const int col = 8 * (nt0 + k) + 2 * t4;
          uint32_t hi, lo;
          split2(st[k][0], st[k][1], hi, lo);
          *reinterpret_cast<uint32_t*>(o + sr_lo * N + col) = hi;
          *reinterpret_cast<uint32_t*>(o + HD * N + sr_lo * N + col) = lo;
          split2(st[k][2], st[k][3], hi, lo);
          *reinterpret_cast<uint32_t*>(o + sr_hi * N + col) = hi;
          *reinterpret_cast<uint32_t*>(o + HD * N + sr_hi * N + col) = lo;
        }
"""
ABLATIONS = {
    "flash_attention": {
        # P = S rounded to bf16: no max, exp, sum or rescale, the products and loads stay
        "no_softmax": [(FLASH_SOFTMAX,
                        "  corr_lo = corr_hi = 1.f;\n#pragma unroll\n  for (int nt = 0; nt < 16; ++nt) {\n"
                        "    pa[nt >> 1][(nt & 1) * 2] = pack_bf16(sc[4 * nt], sc[4 * nt + 1]);\n"
                        "    pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(sc[4 * nt + 2], sc[4 * nt + 3]);\n"
                        "  }\n  return;\n" + FLASH_SOFTMAX)],
        # 2^x replaced by a multiply (in the shared header)
        "no_exp2": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                     "y = x * 0.001f;")],
    },
    "flash_attention_bwd": {
        # the softmax recompute taken out of both kernels: P = S (P^T = S^T)
        # rounded, no exp2, the products, loads and masks stay
        "no_softmax": [("return ex2(fmaf(s, c2, -l2));", "return s;")],
        # a step's dK/dV (dQ) products issued at its end (dK/dV also waited
        # for there) instead of after the next step's S and dP
        "no_defer": [("static constexpr bool DEFER = NCH == 1;",
                      "static constexpr bool DEFER = false;")],
    },
    "ssd_scan": {
        # every tensor-core product removed: loads, cumsum, exps, splits, stores, barriers
        "no_products": [(ln + "\n", "") for ln in dict.fromkeys(
            ln for ln in (ROOT / "src/repro_torch/csrc/ssd_scan.cu").read_text().splitlines()
            if ln.strip().startswith("mma16816("))],
        # the decay factors of M left out (no 2^x per element of M)
        "no_M_exp2": [("m[nt][e] * ex2(ci - csw[j]) * dts[j]", "m[nt][e] * (ci - csw[j]) * dts[j]")],
    },
    "ssd_scan_bwd": {
        # the bf16 chains launch without their forward row (the states entering
        # each chunk are left unwritten): what taking them from the forward would save
        "no_state_chain": [("const bool reverse = blockIdx.y == 1;", "const bool reverse = true;"),
                           ("ssd_bwd_chains_tc<HD, N><<<dim3(p.B * p.H, 2)",
                            "ssd_bwd_chains_tc<HD, N><<<dim3(p.B * p.H, 1)")],
        # every tensor-core product of the chunk kernel removed: loads, exps,
        # splits, sums, stores and barriers stay
        "no_chunk_products": [("  mma16816(acc, a, b0, b1);\n", "")],
        # the chains write no states out: what the write of 537 MB costs them
        "no_state_write": [(SSD_BWD_COPY_OUT, "")],
        # the states written straight from the warps' fragments (16-byte pieces
        # of eight rows a store), as the first version of the chains did
        "fragment_stores": [(SSD_BWD_COPY_OUT, SSD_BWD_FRAGMENT_STORES)],
    },
}


def variants(name):
    """{tag: {file name: text}}: the source and every header of ``csrc/``;
    each substitution applies to the source if it holds the text, else to
    the one header that does."""
    files = {f"{name}.cu": (build.CSRC / f"{name}.cu").read_text()}
    files.update({h.name: h.read_text() for h in sorted(build.CSRC.glob("*.cuh"))})
    out = {"unchanged": files}
    for tag, subs in ABLATIONS[name].items():
        texts = dict(files)
        for a, b in subs:
            holder = next((f for f, t in texts.items() if t.count(a)), None)
            if holder is None:
                raise SystemExit(f"{name} {tag}: the text to remove is not in the source")
            texts[holder] = texts[holder].replace(a, b)
        out[tag] = texts
    return out


def build_all(sources):
    """{(name, tag): {file name: text}} -> {(name, tag): CDLL}, one nvcc each,
    in parallel, each copy in its own directory with its headers."""
    root = build.build_dir().parent / "ablations"
    nvcc, procs = build.find_nvcc(), {}
    for (name, tag), texts in sources.items():
        d = root / f"{name}_{tag}"
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        cu = d / f"{name}.cu"
        procs[name, tag] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(root / f"{key[0]}_{key[1]}" / f"{key[0]}.so"))
    return libs


def bind(module, lib, entry, fn="_fn", getter="_kernel_fn"):
    """Point ``module``'s wrapper at ``lib`` (same C interface)."""
    setattr(module, fn, None)
    real = build.load
    build.load = lambda name: lib
    try:
        getattr(module, getter)()
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
    t = cs.TRAIN_SHAPE
    tq, tk, tv = cs.make_qkv(27, t["B"], t["S"], t["S"], t["Hq"], t["Hkv"], t["hd"], t["dtype"],
                             dev)
    tdo = cs.make_qkv(26, t["B"], t["S"], t["S"], t["Hq"], t["Hq"], t["hd"], t["dtype"], dev)[2]
    tout, tlse = fa.flash_attention(tq, tk, tv, causal=True, return_lse=True)
    cfg = get_config("mamba2-1.3b")
    args = cs.make_ssd(21, 8, 2048, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                       cfg.ssm_groups, torch.bfloat16, dev, served=True, fused=True)
    bargs = cs.make_ssd(22, t["B"], t["S"], cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                        cfg.ssm_groups, torch.bfloat16, dev, served=True, fused=True)
    bdy, _ = cs.ssd_cotangents(23, t["B"], t["S"], cfg.ssm_heads, cfg.ssm_headdim,
                               cfg.ssm_state, torch.bfloat16, dev)
    # name: (module, C entry, wrapper's bound-function attribute, its getter, call)
    calls = {"flash_attention": (fa, "flash_attention_fwd", "_fn", "_kernel_fn",
                                 lambda: fa.flash_attention(q, k, v)),
             "flash_attention_bwd": (fa, "flash_attention_bwd", "_bwd_fn", "_bwd_kernel_fn",
                                     lambda: fa.flash_attention_bwd(tq, tk, tv, tout, tdo, tlse)),
             "ssd_scan": (ssd, "ssd_scan_fwd", "_fn", "_kernel_fn",
                          lambda: ssd.ssd_scan(*args[:5], return_state=True)),
             "ssd_scan_bwd": (ssd, "ssd_scan_bwd", "_bwd_fn", "_bwd_kernel_fn",
                              lambda: ssd.ssd_scan_bwd(*bargs[:5], bdy))}
    sources = {(name, tag): text for name in ABLATIONS for tag, text in variants(name).items()}
    libs = build_all(sources)
    times = {key: [] for key in libs}
    for _ in range(2):
        for (name, tag), lib in libs.items():
            module, entry, fn, getter, call = calls[name]
            bind(module, lib, entry, fn, getter)
            times[name, tag].append(cs.cuda_ms(call, warmup=3, reps=15))
    for name in ABLATIONS:
        setattr(calls[name][0], calls[name][2], None)   # the wrappers' own libraries again
    for (name, tag), ms in times.items():
        print(json.dumps({"kernel": name, "variant": tag, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
