#!/usr/bin/env python3
"""How far tensor parallelism's rounding moves a result, on the CPU.

    python3 tools/tp_rounding.py [--d 1024] [--layers 4] [--seq 256]

A llama-shaped model (head dim 64, ``d / 64`` query and ``max(4, d / 256)``
KV heads, d_ff 4 d, vocab 8192 for the gradients and 32768 for the logits),
random weights from seed 0, batch 4: the gradient of one train step and the
logits of a prefill and four decode steps, each by

* the one-device route in bf16 (``train_grads`` / ``prefill`` + ``decode_step``),
* the TP route in bf16 (``make_train_setup`` zero1 over data 1 x model 2;
  ``make_setup`` fsdp over data 1 x model 4): each rank's partial rounded to
  bf16 before the tree sum,
* the one-device route in fp32, the reference,

and prints, as one JSON line, the worst gradient leaf's relative Frobenius
error of each bf16 route against the other and against fp32, and each step's
logits the same way.  Both bf16 routes are about as far from fp32, and about
that far from each other: the reason ``chip_smoke.py``'s TP cases are held to
the fp32 route (``SETUP_TP_FP32_MARGIN``) and not to the one-device bf16
route within tol(bf16).  It also prints the fp32 TP step's loss and worst
gradient element against the one-device fp32 step (rounding of fp32 sums
alone).  CPU only; a few seconds at the defaults.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import get_config                     # noqa: E402
from repro_torch.launch.mesh import make_mesh                          # noqa: E402
from repro_torch.models import transformer as tfm                      # noqa: E402
from repro_torch.models.config import ParallelConfig, ShapeConfig      # noqa: E402
from repro_torch.models.modules import tree_flatten, tree_map          # noqa: E402
from repro_torch.parallel.sharding import unshard_leaf                 # noqa: E402
from repro_torch.parallel.steps import make_setup, make_train_setup, train_grads  # noqa: E402
from repro_torch.train.optim import OptimConfig                        # noqa: E402

B = 4


def fro(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def config(d, layers, vocab):
    return dataclasses.replace(get_config("llama3.2-1b"), num_layers=layers, d_model=d,
                               n_heads=d // 64, n_kv_heads=max(4, d // 256), head_dim=64,
                               d_ff=4 * d, vocab_size=vocab)


def tp_grads(cfg, params, batch, dtype):
    """The synced gradient of a zero1 step over data 1 x model 2, whole."""
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    setup = make_train_setup(cfg, ShapeConfig("t", "train", batch["tokens"].shape[1], B), mesh,
                             ParallelConfig(param_sharding="zero1", remat="none",
                                            param_dtype=dtype), OptimConfig())
    state = setup.init_state(tree_map(lambda t: t.clone(), params))
    grads, metrics = setup.grad_fn(state, batch)
    specs = tree_flatten(setup.param_shardings, is_leaf=lambda x: isinstance(x, tuple))[0]
    return ([unshard_leaf(g, s, mesh) for g, s in zip(tree_flatten(grads)[0], specs)],
            float(metrics["loss"]))


def gradients(d, layers, seq):
    cfg = config(d, layers, 8192)
    p16 = tfm.init(0, cfg, dtype=torch.bfloat16, device="cpu")
    p32 = tree_map(lambda t: t.float(), p16)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, seq + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def one(params):
        g, m = train_grads(params, batch, cfg, ParallelConfig(remat="none"))
        return tree_flatten(g)[0], float(m["loss"])
    one16, _ = one(p16)
    one32, loss32 = one(p32)
    tp16, _ = tp_grads(cfg, p16, batch, "bfloat16")
    tp32, tp_loss32 = tp_grads(cfg, p32, batch, "float32")
    worst = lambda a, b: max(fro(x, y) for x, y in zip(a, b))   # noqa: E731
    return {"tp_vs_one_device_bf16": worst(tp16, one16),
            "one_device_bf16_vs_fp32": worst(one16, one32), "tp_bf16_vs_fp32": worst(tp16, one32),
            "fp32_loss_rel": abs(tp_loss32 - loss32) / loss32,
            "fp32_grad_max_abs": max(float((x - y).abs().max()) for x, y in zip(tp32, one32))}


@torch.no_grad()
def logits(d, layers, seq):
    cfg = config(d, layers, 32768)
    p16 = tfm.init(0, cfg, dtype=torch.bfloat16, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, seq)))
    feed = [torch.full((B, 1), t) for t in range(4)]

    def one(params):
        lg, st = tfm.prefill(params, {"tokens": toks}, cfg, None, seq + 4)
        out = [lg]
        for tok in feed:
            lg, st = tfm.decode_step(params, tok, st, cfg, None)
            out.append(lg)
        return out
    one16, one32 = one(p16), one(tree_map(lambda t: t.float(), p16))
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    pcfg = ParallelConfig(param_dtype="bfloat16")
    pre = make_setup(cfg, ShapeConfig("p", "prefill", seq + 4, B), mesh, pcfg)
    dec = make_setup(cfg, ShapeConfig("d", "decode", seq + 4, B), mesh, pcfg)
    placed = pre.init_state(p16)
    lg, st = pre.step_fn(placed, {"tokens": toks})
    tp16 = [lg]
    for tok in feed:
        lg, st = dec.step_fn(placed, st, tok)
        tp16.append(lg)
    steps = lambda a, b: [fro(x, y) for x, y in zip(a, b)]       # noqa: E731
    return {"tp_vs_one_device_bf16": steps(tp16, one16),
            "one_device_bf16_vs_fp32": steps(one16, one32), "tp_bf16_vs_fp32": steps(tp16, one32)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args()
    print(json.dumps({"device": "cpu", "d": args.d, "layers": args.layers, "seq": args.seq,
                      "gradients_worst_leaf": gradients(args.d, args.layers, args.seq),
                      "logits_per_step": logits(args.d, args.layers, args.seq)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
