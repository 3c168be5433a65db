#!/usr/bin/env python3
"""The learning rates at which the `stream` phase's first cases train.

    python3 tools/stream_lr_sweep.py [--lrs 1e-2,3e-3,1e-3,3e-4]    # needs an NVIDIA GPU

Builds the kernels, then for each learning rate runs ``chip_smoke.py``'s cases
(a)-(c) of the `stream` phase (``stream_compare``: llama3.2-1b and
mamba2-1.3b at full depth, mixtral-8x7b at 1 layer, bf16, B 4 x S 2048 of
SyntheticLM; the streamed gradient against the monolithic one, then three
steps of the reference's plain SGD) and prints one JSON line a case: the
losses, or the assertion that stopped it (a loss that did not fall).
``chip_smoke.STREAM_LR`` is the largest rate at which every case's loss falls.
About a minute for the build and ten seconds a case on an H100.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lrs", default="1e-2,3e-3,1e-3,3e-4")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_lr_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = cs.phase_env()
    cs.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    link = cs.stream_link(dev)
    for lr in (float(x) for x in args.lrs.split(",")):
        cs.STREAM_LR = lr
        for arch, layers in cs.STREAM_COMPARE:
            try:
                report, _ = cs.stream_compare(dev, card, arch, layers, link)
                out = {"losses": report["losses"]}
            except AssertionError as e:
                out = {"stopped": str(e)}
            print(json.dumps({"lr": lr, "arch": arch, "layers": layers, **out, "card": card}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
