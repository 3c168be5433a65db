"""Perf hillclimbing over the dry run's records.

Counterpart of ``repro.launch.perf``: runs cells through named
``ParallelConfig`` variants (hypothesis, change, measure again), writing
``artifacts/perf/<cell>__<variant>.json`` records with the dry run's schema
(``launch.dryrun.run_cell`` on the ``single`` mesh: placed on the production
mesh, measured on the card).  The hypothesis text is stored in the record, so
that what was predicted can be quoted beside what was measured.  ``PLAN`` has
the JAX package's entries, in its order; each hypothesis states its lever,
and none quotes a number taken on or for another machine.

    PYTHONPATH=src python -m repro_torch.launch.perf [--cell qwen3-32b:train_4k]
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

import torch

# (cell, variant, hypothesis, pcfg overrides)
PLAN = [
    # ---- qwen3-32b train_4k: representative Megatron-style dense train ----
    ("qwen3-32b", "train_4k", "v1_no_tp_fsdp256",
     "The TP activation collectives (a few B_loc·S·d all-reduces a layer over "
     "the model axis) dominate the collective term.  Remapping the model axis "
     "to data parallelism (pure FSDP over every rank; a layer's parameters "
     "gathered instead) should cut the collective term several times: the "
     "paper's thesis that the fabric must let the compiler pick the strategy.",
     {"tp_axis": "", "seq_shard": False}),
    ("qwen3-32b", "train_4k", "v2_no_tp_block_remat",
     "remat=full recomputes the whole forward (8/6 of the model FLOPs).  "
     "With FSDP's memory freed, remat=block (keep each block's input) should "
     "cut the counted FLOPs and bytes accessed, at the price of memory.",
     {"tp_axis": "", "seq_shard": False, "remat": "block"}),

    # ---- mixtral-8x7b train_4k: worst roofline fraction -------------------
    ("mixtral-8x7b", "train_4k", "v1_bucket_constraint",
     "The (G,E,C,d) dispatch buckets of f-sharded experts are replicated "
     "across the model axis.  Pinning their sharding (G over data, f over "
     "model after the projection) makes the boundary one all-to-all-class "
     "exchange; expect the collective term to fall several times.",
     {}),
    ("mixtral-8x7b", "train_4k", "v2_no_tp_fsdp256",
     "8 experts cannot TP-shard over the model axis; with experts f-sharded "
     "every token's activations cross the model axis each layer.  No TP, "
     "FSDP over every rank keeps tokens local (each layer's experts "
     "gathered whole): the collective term should fall to the dense FSDP "
     "level.",
     {"tp_axis": "", "seq_shard": False}),

    # ---- round 2 ------------------------------------------------------------
    ("qwen3-32b", "train_4k", "v3_no_tp_big_attn_chunks",
     "Once the memory term dominates, a share of it is the online-softmax "
     "state (m, l, acc) round-tripping memory per (q, k) block pair.  "
     "Larger chunks (q=2048, k=4096) quarter the trip count; expect bytes "
     "accessed to fall by a fifth to a third.",
     {"tp_axis": "", "seq_shard": False,
      "attn_q_chunk": 2048, "attn_k_chunk": 4096}),
    ("mixtral-8x7b", "train_4k", "v3_no_tp_block_remat",
     "The FLOPs lever of qwen3's v2 on the no-TP mapping: remat=block should "
     "cut the counted FLOPs; memory per rank rises, maybe past what a rank "
     "holds: measure the trade.",
     {"tp_axis": "", "seq_shard": False, "remat": "block"}),
    ("arctic-480b", "train_4k", "v3_dense_residual_tp",
     "The dense-residual FFN has its contraction dim (d_model) FSDP-sharded "
     "over data, forcing partial-sum all-reduces of the activations every "
     "layer.  Sharding it as Megatron column / row TP (contraction whole) "
     "should remove most of that all-reduce traffic.",
     {}),

    # ---- bonus sweep: does the strategy remap generalize? -----------------
    ("llava-next-34b", "train_4k", "v1_no_tp_fsdp256",
     "qwen3's lever: llava's 56 heads do not divide the model axis (padded "
     "per rank), so no TP removes both the TP activation collectives and the "
     "padding's waste.",
     {"tp_axis": "", "seq_shard": False}),
    ("chatglm3-6b", "train_4k", "v1_no_tp_fsdp256",
     "Generalization check on a mid-size dense arch with extreme GQA "
     "(kv=2, replicated under TP).",
     {"tp_axis": "", "seq_shard": False}),
    ("mamba2-1.3b", "train_4k", "v1_no_tp_fsdp256",
     "Attention-free control: SSD blocks have no TP all-reduces of "
     "attention activations, but the in/out projections still sum over "
     "model; expect a smaller but positive gain.",
     {"tp_axis": "", "seq_shard": False}),

    ("arctic-480b", "train_4k", "v4_ep_over_data",
     "v3 leaves the all-gathers and all-reduces at the token->expert "
     "boundary (G data-sharded against E model-sharded: every shard pair "
     "exchanges bucket slices twice a layer).  True EP, experts over the "
     "data axis and their hidden dim TP over model, makes dispatch one "
     "all-to-all over data and the expert products a Megatron sum; predict "
     "a collective term several times lower.",
     {"moe_ep_axis": "data"}),

    # ---- arctic-480b train_4k: most collective-bound ----------------------
    ("arctic-480b", "train_4k", "v1_bucket_constraint",
     "Dispatch buckets to model-sharded experts are gathered to every shard; "
     "pinning buckets to (data x model on G, E) makes the token->expert "
     "boundary an all-to-all: expect a 3-5x collective reduction.",
     {}),
    ("arctic-480b", "train_4k", "v2_seqshard_off",
     "SP resharding (seq<->heads transposes around every attention) adds "
     "all-to-alls without a memory benefit at a small per-rank batch; "
     "disabling SP should trim collectives a few % with no memory regression.",
     {"seq_shard": False}),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None,
                    help="arch:shape filter, e.g. qwen3-32b:train_4k")
    ap.add_argument("--out", default="artifacts/perf")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("repro_torch.launch.perf: torch.cuda.is_available() is False; the perf "
              "variants are measured on an NVIDIA GPU", file=sys.stderr)
        return 2
    from .dryrun import run_cell

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    for arch, shape, variant, hypothesis, overrides in PLAN:
        if args.cell and f"{arch}:{shape}" != args.cell:
            continue
        name = f"{arch}__{shape}__{variant}"
        if (outdir / f"{name}.json").exists():
            print(f"[perf] {name}: cached", flush=True)
            continue
        try:
            rec = run_cell(arch, shape, "single", pcfg_overrides=overrides)
            rec["variant"] = variant
            rec["hypothesis"] = hypothesis
            rec["overrides"] = overrides
        except Exception as e:  # recorded, and the exit code says so
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "variant": variant,
                   "status": "error", "error": f"{type(e).__name__}: {e}"}
            failures += 1
        (outdir / f"{name}.json").write_text(json.dumps(rec, indent=2, default=str))
        if rec["status"] == "ok":
            rf = rec["roofline"]
            print(f"[perf] {name}: frac={rf['roofline_fraction']:.4f} "
                  f"comp={rf['compute_s']:.4f} mem={rf['memory_s']:.4f} "
                  f"coll={rf['collective_s']:.4f} step={rec['seconds']['step']:.4f}s "
                  f"mem/dev>={rec['memory_per_device']['total_bytes'] / 2**30:.1f}GiB",
                  flush=True)
        else:
            print(f"[perf] {name}: {rec['status']}", flush=True)
    if failures:
        print(f"[perf] {failures} FAILURES", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
