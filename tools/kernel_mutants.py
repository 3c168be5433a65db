#!/usr/bin/env python3
"""Mutation check of the flash-attention and SSD-scan kernels (forward and
backward) on a GPU: thirteen planted faults, nine of them in the backwards,
two in the sliding window.

    python3 tools/kernel_mutants.py [name ...]

Copies the tree (and the kernels already built) into a temporary directory
once per mutant, plants one deliberate fault in a CUDA source there, and runs
``python3 chip_smoke.py --phases kernels`` in the copy.  Each mutant must make
it exit non-zero; the script prints the exit code and the assertion that
stopped it, and exits non-zero itself if any mutant passed.  Names given on
the command line run those mutants only.  The checkout is never modified.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLASH = "src/repro_torch/csrc/flash_attention.cu"
SSD = "src/repro_torch/csrc/ssd_scan.cu"
FLASH_BWD = "src/repro_torch/csrc/flash_attention_bwd.cu"
SSD_BWD = "src/repro_torch/csrc/ssd_scan_bwd.cu"

# name: (source, text, replacement) or (source, [(text, replacement), ...])
MUTANTS = {
    # kv tile 10 of 128 keys (keys 1280..1407) leaves every row's sum
    "flash skips kv tile 10": (
        FLASH,
        "  if (!((k0 + kBN > p.Sk) || (p.causal && k0 + kBN - 1 > warp_row0) ||",
        "  if (k0 == 10 * kBN) {\n    for (int i = 0; i < 64; ++i) sc[i] = kMasked;\n"
        "    return;\n  }\n"
        "  if (!((k0 + kBN > p.Sk) || (p.causal && k0 + kBN - 1 > warp_row0) ||"),
    # the window one key too wide: the key at q - window is seen as well
    "flash window one key too wide": (
        FLASH, "(!W || kpos > qpos - p.window);",
        "(!W || kpos >= qpos - p.window);"),
    "ssd skips chunk 20's state update": (
        SSD, "    if (owns) {\n      const float decay",
        "    if (owns && c != 20) {\n      const float decay"),
    "ssd drops the lo half of the state update": (
        SSD, "          mma16816(st[k], al, bb[0], bb[1]);\n", ""),
    # dK / dV of a KV head take only the first query head of its group
    # (producer and consumers walk the same, shortened head range)
    "flash bwd drops the grouped-query sum": (
        FLASH_BWD, "  w.h1 = w.h0 + group;\n", "  w.h1 = w.h0 + 1;\n"),
    # dQ leaves out key tile 5 (keys 320..383) of every row that sees it
    "flash bwd dQ skips key tile 5": (
        FLASH_BWD, "        if (r0 >= p.Sq || (p.causal && k0 > r0 + 63) ||",
        "        if (k0 == 5 * kRingRows || r0 >= p.Sq || (p.causal && k0 > r0 + 63) ||"),
    # the dK/dV walk stops one q tile short of the window's end: the last
    # queries that see a key tile's last keys leave their share out of dK, dV
    "flash bwd window walk one q tile short": (
        FLASH_BWD, "  const long long e = ((long long)k0 + n - 1 + p.window - 1) / rows + 1;",
        "  const long long e = ((long long)k0 + n - 1 + p.window - 1) / rows;"),
    # a fault of the pipeline: at hd 64 the dK/dV consumers read Q and dO for
    # S^T and dP^T from the ring stage after the one their full barrier guards
    # (the barriers are kept, so the call returns; the tile is another step's,
    # or not yet loaded)
    "flash bwd dK/dV reads the wrong ring stage": (
        FLASH_BWD, "          issue_step(first, sRing + s * 2 * C::RING_TILE);",
        "          issue_step(first, sRing + ((s + 1) % STAGES) * 2 * C::RING_TILE);"),
    # the reverse chain leaves the gradient of the state as it is at chunk 1,
    # so chunk 0 sees the gradient that leaves chunk 1, not chunk 0 (bf16)
    "ssd bwd skips the reverse dh carry at chunk 1": (
        SSD_BWD, "    if (owns) {\n      const float decay = expf(last);",
        "    if (owns && !(reverse && c == 1)) {\n      const float decay = expf(last);"),
    # dB of a group takes its first partial only: one head in fp32 calls, one
    # block of k heads in bf16 calls (dC keeps the whole sum)
    "ssd bwd dB sums one head block": (
        SSD_BWD, "  for (int r = 0; r < nkb; ++r) s += src[(long long)r * N];",
        "  for (int r = 0; r < (is_c ? nkb : 1); ++r) s += src[(long long)r * N];"),
    # a block's dB and dC leave out its last head (four places: the products
    # with Gd^T and Gd, and the state terms)
    "ssd bwd sums k-1 heads inside the block": (
        SSD_BWD, [
            ("      if (kk < rt || !has_n) continue;",
             "      if (kk < rt || !has_n || hh + 1 == p.kheads) continue;"),
            ("      if (kk > rt || !has_n) continue;",
             "      if (kk > rt || !has_n || hh + 1 == p.kheads) continue;"),
            ("    if (has_n) {\n      float tb[NW][4];",
             "    if (has_n && hh + 1 < p.kheads) {\n      float tb[NW][4];"),
            ("          dCs[t][0] += v0;", "          if (hh + 1 < p.kheads) dCs[t][0] += v0;")]),
    # two bf16 roundings inside the arithmetic, so that only the bf16 limits
    # can catch them: M^T of the chunk without its lo half (M rounded to bf16
    # once), and the carried states of both chains rounded to bf16
    "ssd bwd drops the lo half of M": (
        SSD_BWD, "mma_tiles<DW, true, true, false>(dxa, ah, al, ys, ys, LDX, 16 * kk, d0);",
        "mma_tiles<DW, true, false, false>(dxa, ah, al, ys, ys, LDX, 16 * kk, d0);"),
    "ssd bwd rounds the carried states to bf16": (
        SSD_BWD,
        "          mma16816(st[k], al, bb[0], bb[1]);\n        }\n      }\n",
        "          mma16816(st[k], al, bb[0], bb[1]);\n        }\n      }\n"
        "      for (int k = 0; k < TPW; ++k)\n"
        "        for (int e = 0; e < 4; ++e) st[k][e] = __bfloat162float(__float2bfloat16(st[k][e]));\n"),
}


def run(name: str, source: str, text, new=None) -> int:
    subs = text if new is None else [(text, new)]
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / "tree"
        shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
            "build", "artifacts", ".git", "__pycache__"))
        # the libraries already built: only the mutated source is built again
        # (the build's hash covers each source's text)
        if (ROOT / "build" / "repro_torch").is_dir():
            shutil.copytree(ROOT / "build" / "repro_torch", copy / "build" / "repro_torch")
        path = copy / source
        src = path.read_text()
        for a, b in subs:
            if src.count(a) != 1:
                raise SystemExit(f"{name}: the text to mutate is not in {source} exactly once")
            src = src.replace(a, b)
        path.write_text(src)
        r = subprocess.run([sys.executable, "chip_smoke.py", "--phases", "kernels"],
                           cwd=copy, capture_output=True, text=True)
    why = [ln for ln in r.stderr.splitlines() if "Error" in ln][-1:]
    print(f"{name}: exit {r.returncode}: {why[0] if why else r.stderr[-400:]}", flush=True)
    return r.returncode


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_mutants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(MUTANTS)
    unknown = [n for n in names if n not in MUTANTS]
    if unknown:
        print(f"kernel_mutants: no mutant {unknown}; there are {list(MUTANTS)}", file=sys.stderr)
        return 2
    passed = [name for name in names if run(name, *MUTANTS[name]) == 0]
    if passed:
        print(f"mutants not caught: {passed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
