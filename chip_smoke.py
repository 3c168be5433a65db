#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port starts and is right on a GPU.

    python3 chip_smoke.py                      # every phase, needs one NVIDIA GPU
    python3 chip_smoke.py --phases kernels     # bring-up: build and check only

Drives the port's main paths (``repro_torch``: serving llama3.2-1b, serving
mamba2-1.3b, serving the MoE family (mixtral-8x7b with its sliding window,
arctic-480b), serving llava-next-34b (an image-patch prefix) and whisper-medium
(encoder, cross-attention, cross caches), FRED's gradient synchronisation of
llama3.2-1b's gradients over a pod 2 x data 4 mesh in its flat, hierarchical
and int8 error-feedback modes, training llama3.2-1b, mamba2-1.3b and
mixtral-8x7b through ``Trainer.run()``, and llava and whisper through
``make_train_step``, and the multi-rank layer with every rank stacked on the
card: mixtral's and arctic's MoE layers with their experts over data 4, and
llama3.2-1b as a 4-stage GPipe pipeline; and the data-parallel setups:
llama3.2-1b trained zero1, replicated and fsdp, mamba2-1.3b fsdp, each
rank's gradient synchronised through the tree-reduce kernel, and llama3.2-1b
and whisper-medium served fsdp through make_setup; and tensor parallelism
over model, every TP all-reduce through the tree-reduce kernel: llama3.2-1b
trained over data 2 x model 2 and pod 2 x data 2 x model 2, whisper-medium
trained and served over data 2 x model 2, llama3.2-1b and llava-next-34b
served over model 4; the MoE family under tensor and expert parallelism:
mixtral-8x7b trained over data 2 x model 2 and served with its experts over
data 2, arctic-480b served over model 2; the SSM and hybrid families under
tensor parallelism: mamba2-1.3b trained over data 2 x model 2 and served at
full depth, zamba2-2.7b trained over model 4 and served over data 2 x
model 2; heads that do not divide the TP degree and the flash-decoding layout
of the decode caches: llama3.2-1b served over model 16 and, one sequence of
8192 tokens, over data 2 x model 2, qwen1.5-4b trained over data 2 x model 8
and served over model 8, mixtral-8x7b served over model 16 past its window;
and llama3.2-1b trained by ``Trainer(mesh=)`` over data 2 x model 2, its
checkpoint of the sharded state resumed after a failure on the survivors and
on one device; and weight streaming: llama3.2-1b, mamba2-1.3b, mixtral-8x7b at
the depth the host's memory holds and arctic-480b at 2 layers trained with
each layer streamed from pinned host memory; and the launch tools' dry-run
records of llama3.2-1b's train cell, mamba2-1.3b's prefill, mixtral-8x7b's
decode and a perf variant, each measured on the card) through the entry
points a user calls, builds every CUDA kernel from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, and shows by the
kernels' launch counts that each path went through its kernels.  Each phase prints one JSON line; any failure exits
non-zero.  Without a CUDA device the script exits non-zero and prints no
result.

Phases:
  env      torch / CUDA versions, the card's name and power limit
  build    nvcc on every ``src/repro_torch/csrc/*.cu`` (all started together)
  kernels  flash_attention against flash_attention_plain: a sweep of small
           shapes, ragged shapes at each head dim and the parity phase's
           shape, then the serving prefill shape (peaked and near-uniform
           softmax) with timings; flash_attention_bwd against autograd through
           flash_attention_plain (fp32): the same sweep in fp32 and bf16,
           causal and not, then llama3.2-1b's training shape (B 4, S 2048,
           peaked and near-uniform softmax, two calls bit-equal) with timings,
           the plain backward and autograd through
           scaled_dot_product_attention beside it, and the same work at hd 128
           (B 2), timed; both with a sliding window: ragged shapes at hd 64 /
           80 / 128, fp32 and bf16, windows 1, 63, 64, 65, 127, 128, 129 and
           one longer than the sequence, then mixtral-8x7b's attention (B 1,
           S 8192, 32 / 8 heads of hd 128, window 4096, bf16) forward and
           backward, timed, the bounds counting only the pairs inside the
           window, the library yardstick scaled_dot_product_attention with
           the band as a boolean mask; whisper's shapes, non-causal (the
           sweep: Sq 37 / Sk 1500, Sq 1500 / Sk 37, 1500 / 1500 at 16 / 16
           heads of hd 64, and 56 / 8 heads of hd 128; timed: its
           cross-attention B 8, Sq 448, Sk 1500 and its encoder B 8, S 1500,
           forward and backward), llava's training shape (B 4, S 2048, 56
           / 8 heads of hd 128, causal), a TP rank's padded heads in the
           setup phase's case (u) (B 4, S 2048, 3 / 3 heads of hd 128,
           causal) and the launch phase's rank shapes (B 1, S 4096, causal:
           llama3.2-1b's 16 / 4 heads of hd 64 at model 2, chatglm3-6b's 32 /
           2 of hd 128), each beside its bound, its plain version and
           scaled_dot_product_attention (or autograd through it);
           ssd_scan against ssd_scan_plain: the
           reference's sweep and two shapes at the bf16 kernel's tile edges
           (fp32 / bf16, with and without an initial state), strided slices
           of one conv output,
           then mamba2's and zamba2's serving prefill shapes, y and the final
           state, with timings, and the setup phase's and the launch
           phase's (b) shapes at a TP rank's heads (SSD_TP_FWD; (b): B 1, S
           32768, 32 heads); ssd_scan_bwd against ssd_scan_bwd_plain: the
           same sweep in fp32 and bf16, with and without an initial state and
           a final-state cotangent, contiguous and as strided slices of one
           conv output, then mamba2's and zamba2's training shapes (B 4,
           S 2048; two calls bit-equal) with timings, the plain backward and
           autograd through ssd_scan_plain beside them, and at a TP rank's
           heads (SSD_TP_BWD; zamba2's 20 heads give k = 5); tree_reduce,
           quantize and dequantize bit for bit against their plain
           versions: the reference's sweeps in fp32 and bf16, strided batch
           views, a rounding-tie case, then the sync phase's largest leaf
           (llama3.2-1b's embedding) at the shapes the sync gives them, with
           timings
  parity   on the card (kernels) against the CPU (plain versions), fp32 at
           full width: llama3.2-1b at 2 layers, mamba2-1.3b at 2 layers and
           zamba2-2.7b at 12 layers (two applications of the shared block);
           prefill logits and 4 decode steps, SSM states and conv lags;
           mixtral-8x7b at 1 layer: the expert choices first (a token may
           choose other experts on the two devices only at a near-tie, gap <
           ROUTE_TIE_EPS; the flips are counted), then the FFN outputs, the
           logits and the KV cache where the routing agrees; llava-next-34b
           at 1 layer (1024 patches + 64 tokens) and whisper-medium at 2
           encoder and 2 decoder layers (1500 frames, 64 tokens): logits, the
           KV and cross caches, 4 decode steps; the compressed gradient sync
           of the reduced llama3.2-1b tree
  serve    llama3.2-1b, then mamba2-1.3b, at full width and depth, bf16: 8
           requests through ``Engine.run_batch``, twice each; then
           mixtral-8x7b at full width and 16 of 32 layers, the same, and a
           batch of 2 requests of 6144-token prompts (past the window: the
           windowed kernel on the served path, decode wrapping the rolling
           cache); then arctic-480b at full width and 2 of 35 layers, the
           same 8 requests twice; one flash launch a layer per batch
           (asserted); then, through tfm.prefill and tfm.decode_step (the
           Engine takes text prompts only, as the JAX one), llava-next-34b
           at full width and 30 of 60 layers (8 x (1024 patches + 1024
           tokens), cache 4096) and whisper-medium at full width and depth
           (8 x 224 tokens against 1500 frames, cache 448), 32 greedy tokens,
           twice each, equal tokens; 30 and 72 flash launches a batch
           (asserted)
  sync     llama3.2-1b's full gradient tree (146 leaves, bf16, 8 replicas
           drawn on the card) through ``build_sync`` in each mode, three times
           each: the mean against an fp32 sum, error buffers, launch counts,
           wall time and peak memory; then 20 error-feedback steps on the
           embedding gradient
  train    fault F1 (an SSD scan and an attention whose inputs require
           grad launch their forward and backward kernels once each and give
           the plain versions' gradients); fp32 at full width, loss and every
           gradient on the card against the CPU: llama3.2-1b and mamba2-1.3b
           at 2 layers, zamba2-2.7b at 12 (two applications of the shared
           block); then llama3.2-1b at full width and depth (bf16 params,
           fp32 master and moments, block remat, B 4 x S 2048) through
           ``Trainer.run()``: 4 steps and a checkpoint, a resume, one more
           step; step time, tokens/s, MFU against 989 TFLOP/s, peak memory,
           launches per step (asserted: 32 forward, 16 backward); then
           mamba2-1.3b the same way, 3 steps (its final checkpoint is
           written, its step checked, and removed; asserted: 96 SSD
           forward, 48 backward); then mixtral-8x7b at full width and 1 of
           32 layers the same way, 3 steps (MFU on the active parameters,
           the router's aux loss in every step; asserted: 2 flash forward,
           1 backward a step; at S 2048 its window of 4096 cuts nothing);
           then through ``make_train_step``, 3 steps on one batch:
           llava-next-34b at full width and 2 of 60 layers (B 4 x (1024
           patches + 1024 tokens)) and whisper-medium at full width and depth
           (B 8, 1500 frames, 448 tokens); asserted: llava 4 flash forward
           and 2 backward a step, whisper 144 and 72; the card-against-CPU
           gradients above include llava at 1 layer (192 patches + 256
           tokens, mm_proj's gradient) and whisper at 2 + 2 layers (the
           encoder's gradients)
  parallel every rank of a StackedMesh on the card: mixtral-8x7b's MoE layer
           at full width with its experts over data 4 (moe_ep_ffn_fn on the
           placed experts and batch, B 4 x S 2048, bf16) against
           moe_ffn(n_groups=4): outputs, aux and the gradients of x and of
           every weight through the inverse exchanges; arctic-480b's layer
           (128 experts, 32 a rank, its dense residual) forward; llama3.2-1b
           at full width and depth as 4 GPipe stages of 4 blocks
           (pipeline_fn, 8 microbatches of 1 x 2048, block remat inside a
           stage, the embedding and the head with its loss outside) against
           sequential_reference of the same stage function: output, loss and
           every parameter's gradient, 256 flash forward and 128 backward
           launches each (asserted); each timed in turns, with its peak memory
  setup    llama3.2-1b at full width and depth (bf16 params, fp32 master and
           moments, block remat, B 8 x S 2048, labels masked unevenly over
           the ranks' shards) through make_train_setup with every rank of a
           StackedMesh on the card: (a) zero1 over data 4, flat sync; (b)
           replicated over pod 2 x data 2, hierarchical sync; two steps each
           from one state against the one-device make_train_step on the
           whole batch: the loss of each step (2e-3 relative), every synced
           gradient leaf of step 1 (relative Frobenius within tol(bf16)),
           zero1's AdamW update bit-equal to the replicated one on (a)'s
           synced gradient, the launches of every step (asserted: 4 x (32 +
           16) flash, 146 (a) or 292 (b) tree reduces); then (c) fsdp over
           data 4, flat, and (d) fsdp over pod 2 x data 2 x model 1,
           hierarchical (embed over data alone, the shards summed over pod
           too), the same way, each block gathered when it runs (gathers
           counted and asserted: 4 x (2 + 2 x 9 x 16) a step), step 1's
           synced gradient shards and updated parameters bit-equal to (a)'s
           and (b)'s; (e) mamba2-1.3b at full width and 12 of 48 layers, fsdp
           over data 4, one step (4 x (24 + 12) SSD launches asserted); step
           seconds, peak memory, the parameter and optimizer bytes a rank
           holds, and the memory the one-device step leaves to the
           collector once dropped; (f) serving through make_setup, fsdp over
           data 4: llama3.2-1b at full depth (8 x 2048 tokens, 16 steps; 64
           flash launches a prefill, asserted) and whisper-medium at full
           depth (8 x 224 tokens against 1500 frames, 16 steps; 288), the
           logits bit-equal to the one-device prefill / decode_step on each
           rank's rows; against the whole batch, greedy tokens equal but at
           near-ties (counted) and the elements outside tol(bf16) counted;
           then tensor parallelism over model (each rank its heads, MLP
           columns and vocab block, the partials summed by the tree reduce):
           (g) llama3.2-1b zero1 over data 2 x model 2, flat, two steps; (h)
           fsdp over the same, its step 1 bit-equal to (g)'s; (i) fsdp over
           pod 2 x data 2 x model 2, hierarchical, one step; (j)
           whisper-medium at full depth fsdp over data 2 x model 2, one step
           and served as (f); (k) llama3.2-1b and llava-next-34b (8 of 60
           layers) served over data 1 x model 4: losses within 1e-4 of the
           one-device step, flash and tree-reduce launches asserted
           (``tp_tree_launches``), gradients and logits held against the
           fp32 one-device route as far as the bf16 one is
           (SETUP_TP_FP32_MARGIN), the elements outside tol(bf16) of the
           bf16 route counted, greedy flips at near-ties only; then, on a
           line of its own, the MoE family under tensor parallelism (the
           router once on a row's whole input, each rank its experts or
           their mlp block) and expert parallelism (moe_ep_axis: the lanes of
           the data axis through each MoE block together, the all-to-all
           over them): (l) mixtral-8x7b at 1 of 32 layers trained fsdp over
           data 2 x model 2, two steps; (m) the same one step, replicated,
           the experts over data and their mlp dim over model; (n)
           arctic-480b at 1 of 35 layers served over data 1 x model 2; (o)
           mixtral at 4 layers served with the experts over data 2 and
           model 2 (8 x 512 tokens, 8 steps): as (g)-(k), and the routing
           against the fp32 route's (a token may choose other experts only
           at a near-tie there, counted; logits compared on the rows whose
           last token's routing agrees), a rank's expert bytes; then, on
           a line of its own, the SSM and hybrid families under tensor
           parallelism (each rank projects and convolves its block of the
           fused columns and channels, two gathers, each rank scans its
           heads): (p) mamba2-1.3b at 12 of 48 layers trained fsdp over data
           2 x model 2, two steps; (q) zamba2-2.7b at 12 of 54 layers
           trained replicated over data 1 x model 4, one step (the SSD
           backward at 20 heads a rank, k = 5); (r) mamba2-1.3b at full
           depth and (s) zamba2-2.7b at 12 layers served fsdp over data 2 x
           model 2 (8 x 2048 tokens, 16 steps): as (g)-(k), every SSD scan
           and flash call at a rank's heads (asserted); then, on a line of
           its own, heads that do not divide the TP degree (a rank projects
           its block of the flattened head columns, the query and KV columns
           gathered where their heads do not divide, each rank attends at its
           padded query heads) and the flash-decoding layout of the decode
           caches (each rank its block of the caches' sequence; a decode step
           combines the ranks' softmax statistics by two tree reduces and an
           all-gather): (t) llama3.2-1b at full depth served over data 1 x
           model 16 (8 prompts of 1024-2048 tokens left-padded to 2048, 16
           steps); (u) qwen1.5-4b at 4 of 40 layers (20 / 20 heads: 3 a rank,
           rank 7 none) trained fsdp over data 2 x model 8, one step at B 8
           x S 2048, and served over data 1 x model 8 (8 x 2048, 8 steps);
           (v) mixtral-8x7b at 2 of 32 layers served over data 1 x model 16
           (2 prompts of 6144 past its window, 16 steps); (w) llama3.2-1b
           served over data 2 x model 2 with one sequence of 8192 tokens
           (16 steps; the caches' sequence over all four ranks): as (g)-(k),
           the flash launches at a rank's padded heads and the decode steps'
           tree reduces asserted (``tp_tree_launches``, ``flash_ranks``),
           the decode-state bytes a rank holds; last, on a line of its own,
           (x) Trainer(mesh=), checkpoints of sharded state and the elastic
           resume: llama3.2-1b at full depth (B 8 x S 2048 of SyntheticLM)
           through the one-device Trainer (steps 1-2 and their checkpoint,
           step 3) and the Trainer over data 2 x model 2, fsdp (steps 1-2,
           the async checkpoint of the logical state); the mesh's losses
           within 2e-3, its checkpoint leaf by leaf against the one-device
           one's (bf16 parameters to tol(bf16), the fp32 master and moments
           against an fp32 route's as far as the one-device run's are);
           faults.crash_and_recover (a torn save of step 3, one rank of four
           dead) onto data 1 x model 2 and step 3 there, the one-device
           Trainer resumed from the mesh's checkpoint and step 3, each
           against the reference's step 3; launches of every step, save
           and resume seconds, the resume's peak memory (asserted under the
           placed state plus twice its largest leaf)
  stream   weight streaming (train/streaming.py: the parameters in pinned
           host memory, each layer streamed to the card for the forward and
           again for the backward's recompute, its gradient streamed back and
           the host weights updated by the reference's plain SGD on a host
           thread as it lands), bf16, B 4 x S 2048 of SyntheticLM, full
           width: the link once (a 1 GiB pinned copy each way; what
           pin_memory=True holds for 1 GiB + 4 KiB); (a) llama3.2-1b and (b)
           mamba2-1.3b at full depth and (c) mixtral-8x7b at 1 layer,
           stream_grads against the monolithic loss_fn gradient with block
           remat (the total and every leaf bit-equal or within tol(bf16),
           each leaf that is not bit-equal named), then 3 stream_train_steps
           (losses falling); (c) mixtral at as many of its 32 layers as
           MemAvailable holds with 16 GiB to spare and (d) arctic-480b at 2
           of 35 layers, each layer drawn on the card one at a time, 2 steps
           (losses finite, aux > 0), each deep case at no more layers than
           its steps' host update covers in STREAM_DEEP_BUDGET_S at the rate
           (a)-(c) measured, two at least, so that arctic's one-slot ring
           swaps (the cut printed); every step's launches asserted (a
           block-remat step's); per step the wall, the H2D and D2H bytes and
           seconds, the host update's seconds and threads, the device-busy
           seconds, the overlap share, which of link, device and host update
           sets the pace, the pinned bytes asked for and held, and the peak
           device memory beside the reckoned figure
  launch   the launch tools (repro_torch.launch.dryrun / perf): dry-run cells
           placed on the production mesh (meta device) and measured with every
           rank of a StackedMesh on the card, the production axes cut to 2:
           (a) llama3.2-1b train_4k over data 2 x model 2 (B 2 x 4096) at
           L1, L2 and full depth, the probe-corrected FLOPs, bytes and
           collective bytes asserted equal to the full depth's count; (a') a
           reduced llama3.2-1b step (d 256, head dim 64, 2 layers) counted on
           the card and on the CPU: FLOPs, bytes (op by op) and collective
           bytes equal; (b) mamba2-1.3b
           prefill_32k (B 2 x 32768) at L1, L2 and full depth; (c)
           mixtral-8x7b decode_32k over pod 2 x data 2 x model 2 (B 4, cache
           32768) at the probe depths (the reckoning keeps the full depth
           off the card); (d) ep_compare (measured / bucket = 1); (e)
           serving_compare; (f) perf.PLAN's chatglm3-6b train_4k
           v1_no_tp_fsdp256 at the probe depths; every record written under
           artifacts/launch and summarised on one line, the kernels each
           counted step must launch asserted
  profile  (only when named) device time by kernel over one prefill and four
           decode steps of llama3.2-1b, mamba2-1.3b and mixtral-8x7b (16
           layers), over one sync of each mode, and over one train step of
           llama3.2-1b, mamba2-1.3b and mixtral-8x7b (1 layer), from
           torch.profiler; for mixtral also the device time inside its MoE
           FFN, dispatch and combine (profiler ranges); then llava's prefill
           (30 layers) and four decode steps, and whisper's train step

Each phase runs under its own wall-clock limit (``PHASE_LIMIT_S``): past it the
script exits with code 3 and names the phase.  A ``{"phase_seconds": ...}`` line
gives each phase's time.  The line before the last is ``{"kernels": [...]}`` (one entry per kernel:
error against the plain version, times, roofline bound, launches on the main
path; the flash kernels also their launches in the pipeline, the flash and
tree-reduce kernels their launches in the setup, the flash and SSD kernels
their launches in the stream, and the flash, SSD and tree-reduce kernels
their launches in the launch phase, by case); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.kernels import build, ops                   # noqa: E402
from repro_torch.kernels.flash_attention import (             # noqa: E402
    attention_pairs, flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_plain, flash_bwd_work, flash_fwd_work, window_pairs)
from repro_torch.kernels.quant8 import (                      # noqa: E402
    dequantize, dequantize_plain, dequantize_work, quantize, quantize_plain, quantize_work)
from repro_torch.kernels.reduce_tree import (                 # noqa: E402
    tree_reduce, tree_reduce_plain, tree_reduce_work)
from repro_torch.kernels.ssd_scan import (                    # noqa: E402
    bwd_heads_per_block, bwd_scratch, ssd_bwd_work, ssd_fwd_work, ssd_scan, ssd_scan_bwd,
    ssd_scan_bwd_plain, ssd_scan_plain)
from repro_torch.models import moe                           # noqa: E402
from repro_torch.models import transformer as tfm            # noqa: E402
from repro_torch.launch import dryrun, perf, roofline         # noqa: E402
from repro_torch.launch.mesh import make_mesh                 # noqa: E402
from repro_torch.models.config import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.models.layers import apply_attn_block      # noqa: E402
from repro_torch.models.modules import (                      # noqa: E402
    rms_norm, softmax_cross_entropy, tree_flatten, tree_map, tree_unflatten)
from repro_torch.parallel import compress                    # noqa: E402
from repro_torch.parallel.pipeline import (                  # noqa: E402
    pipeline_fn, sequential_reference, stack_stages)
from repro_torch.parallel.sharding import Ruleset, shard_leaf, unshard_leaf  # noqa: E402
from repro_torch.parallel import steps as steps_module       # noqa: E402
from repro_torch.parallel.steps import (                     # noqa: E402
    TrainState, _enc_fn, make_setup, make_train_setup, make_train_step, moe_ep_ffn_fn,
    train_grads)
from repro_torch.parallel.collectives import (               # noqa: E402
    MODES, _pad_to, build_sync, init_error_feedback)
from repro_torch.serve.engine import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.train import checkpoint as ckpt             # noqa: E402
from repro_torch.train import faults                          # noqa: E402
from repro_torch.train import streaming                       # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM   # noqa: E402
from repro_torch.train.optim import OptimConfig, init_adam   # noqa: E402
from repro_torch.train.streaming import (                     # noqa: E402
    HostParams, stream_grads, stream_train_step)
from repro_torch.train.train_loop import Trainer, TrainerConfig  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W): bf16 and
# the memory rate as launch.roofline states them, fp32 (non-tensor) beside them.
PEAK_FLOPS = {torch.bfloat16: roofline.PEAK_FLOPS, torch.float32: 67e12}
PEAK_BYTES_PER_S = roofline.HBM_BW

PHASES = ("env", "build", "kernels", "parity", "serve", "sync", "train", "parallel", "setup",
          "stream", "launch")
# Wall-clock limit of each phase in seconds, several times its time on an H100
# (the `phase_seconds` line).  A phase past its limit (a kernel that never
# returns, a stalled disk) ends the process with exit code 3 and a message that
# names the phase, instead of using up the whole run's time.
PHASE_LIMIT_S = {"env": 60, "build": 300, "kernels": 300, "parity": 300, "serve": 300,
                 "sync": 300, "train": 600, "parallel": 240, "setup": 480, "stream": 600,
                 "launch": 300, "profile": 300}

# the serving prefill shape: 8 requests padded to 2048 tokens of llama3.2-1b
MAIN_SHAPE = dict(B=8, S=2048, Hq=32, Hkv=8, hd=64, dtype=torch.bfloat16,
                  causal=True)
# the reference's sweep (tests/test_kernels.py) as (B, Sq, Sk, Hq, Hkv, hd),
# plus the parity phase's shape and ragged cases
SWEEP = [(1, 64, 64, 1, 1, 64), (2, 128, 128, 4, 4, 64),
         (1, 200, 200, 2, 2, 80), (2, 96, 96, 8, 8, 128),
         (2, 72, 200, 4, 2, 64),        # Sq != Sk, grouped KV heads
         (1, 300, 130, 6, 2, 128),      # Sq > Sk: rows past the last key
         (2, 640, 640, 32, 8, 64),      # what the parity phase's prefill launches
         # ragged against the bf16 kernel's 128-row q tiles and 128-key kv tiles,
         # at each head dim (hd 80: a zero-filled second TMA box; hd 128: two boxes)
         (1, 1000, 1000, 8, 2, 64), (1, 333, 333, 4, 4, 80), (1, 257, 257, 4, 2, 128),
         # whisper: Sk 1500 = 11 x 128 + 92 ragged against the key tiles, Sq far
         # below and far above it (cross-attention, and the backward's lse / D
         # rows padded to Sq rounded up to 128), its encoder's Sq = Sk = 1500,
         # 16 / 16 heads (a group of one) at hd 64
         (1, 37, 1500, 16, 16, 64), (1, 1500, 37, 16, 16, 64), (1, 1500, 1500, 16, 16, 64),
         # llava / arctic: 56 / 8 heads, a group of 7 query heads per KV head, hd 128
         (1, 200, 330, 56, 8, 128)]


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

# the SSD scan: the reference's sweep (tests/test_kernels.py) as
# (B, S, H, hd, N, G) and two cases at the bf16 kernel's tile edges, then the
# serving prefill shapes (8 requests padded to
# 2048 tokens) of mamba2-1.3b (the main path) and of zamba2-2.7b's Mamba2 layers
SSD_SWEEP = [(2, S, 4, 16, 8, G) for S in (64, 100, 96) for G in (1, 2)] + [
    # the bf16 kernel's tile edges: hd 64 split over two blocks, N 128 and 64,
    # a ragged last chunk (200 = 3 x 64 + 8, 130 = 2 x 64 + 2), two groups
    (2, 200, 4, 64, 128, 1), (2, 130, 4, 32, 64, 2)]
SSD_SERVED = ("mamba2-1.3b", "zamba2-2.7b")
# the SSD kernels at a tensor-parallel rank's heads, the shapes the setup
# phase's SSM cases (p)-(s) launch at S 2048 and the launch phase's (b) at S
# 32768: (arch, batch rows a call, S, heads a rank).  Forward: mamba2's 32 of
# 64 at model 2 ((p), (r); 4 rows: B 8 over data 2; (b): B 2 over data 2),
# zamba2's 40 of 80 at model 2 ((s)) and 20 at model 4 ((q), B 8).  Backward:
# (p) and (q); at 20 heads the bf16 backward takes k = 5 heads a block
# (``bwd_heads_per_block``).
SSD_TP_FWD = [("mamba2-1.3b", 4, 2048, 32), ("zamba2-2.7b", 4, 2048, 40),
              ("zamba2-2.7b", 8, 2048, 20), ("mamba2-1.3b", 1, 32768, 32)]
SSD_TP_BWD = [("mamba2-1.3b", 4, 32), ("zamba2-2.7b", 8, 20)]
# Kernel and plain version compute from the same inputs, in another order: the
# fp32 kernel in fp32, the bf16 kernel on the tensor cores with every operand
# that is not an exact bf16 input (M, w.x, the carried state) split into two
# bf16 halves, about 16 mantissa bits, with fp32 sums.  So the final state (fp32
# in both) agrees to about 2^-16 of its size, well inside SSD_STATE_TOL, and
# y differs by about one rounding to x's dtype: in bf16 at most one ulp
# (2^-8 of the value), so a row's largest error is at most 2^-8 * 8 = 0.03 of
# the row's rms (hd 64).  A state update left out of one chunk moves the next
# chunk's first rows by about their own size.
SSD_STATE_TOL = dict(atol=1e-4, rtol=1e-3)
# The SSD backward against ssd_scan_bwd_plain on the card, in the style of the
# BWD_* limits: elementwise within ATOL x the gradient's largest magnitude +
# RTOL x the element, and a Frobenius limit.  In fp32 both compute in fp32 from
# the same inputs, sums in another order (about 1e-5 of the norm apart).  Every
# bf16 case (the sweep's and both training shapes) runs the tensor-core kernel,
# whose operands that are not exact bf16 inputs are split into bf16 hi + lo
# halves (about 16 of fp32's 24 bits); dx, dB and dC are rounded once to bf16
# on both sides, so an element differs by at most one ulp, at most 2^-7 of
# itself (inside RTOL 1e-2), and the elements that round apart give 1.0e-4 to
# 1.6e-4 of the norm (5.9e-5 with the earlier fp32 FMA kernels).  The bf16
# Frobenius limits sit 2-3x above that and below what one bf16 rounding inside
# the arithmetic gives: M rounded to bf16 moves dx by 2.4e-3-2.8e-3 of its
# norm, the chunk kernel's dh operand rounded by 7e-4-1e-3
# (tests/test_torch_ssd_bwd_precision.py), the carried states rounded move dx,
# dB, dC or dA by up to 3.2e-4-7.1e-4 (the plain version so altered, on the
# sweep's bf16 cases).  ddt and dA are long sums whose terms cancel, held by
# Frobenius only; dh0 is fp32 on both sides, held to the fp32 limits.
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dh0")
SSD_BWD_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}
SSD_BWD_RTOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
SSD_BWD_FRO_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-4}
SSD_BWD_SUM_FRO_TOL = 3e-4

# the gradient sync: llama3.2-1b's gradients over pod 2 x data 4 (R = 8, the
# mesh of tests/test_multidevice.py); its largest leaf is the embedding
SYNC_ARCH = "llama3.2-1b"
SYNC_MESH = ((2, 4), ("pod", "data"))
# the reference's sweeps (tests/test_kernels.py) as (N, L) and (n, block), plus
# N = 64 (the kernel's largest) and the largest block the kernel takes
TREE_SWEEP = [(2, 100), (7, 1000), (16, 4096), (33, 513), (64, 777)]
QUANT_SWEEP = [(100, 64), (5000, 512), (4096, 1024), (30000, 12288)]


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


def row_rel_err(got, want, row_floor=1e-30):
    """Largest error of a row (the last axis) over that row's rms in ``want``,
    or over ``row_floor`` where the row's rms is smaller."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(dim=-1)
    rms = want.pow(2).mean(dim=-1).sqrt().clamp_min(row_floor)
    return float((err / rms).max())


def hold(name, got, want, atol, rtol, row_limit, row_floor=1e-30):
    """check_close and the row measure together; on failure the message
    carries both, so a run that fails says by how much."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    n_bad = int((err > atol + rtol * want.abs()).sum())
    rel = row_rel_err(got, want, row_floor)
    if n_bad or rel > row_limit:
        raise AssertionError(
            f"{name}: {n_bad} of {err.numel()} elements outside atol={atol} "
            f"rtol={rtol}; max abs err {float(err.max()):.3e}; row error over "
            f"row rms {rel:.3e} (limit {row_limit})")
    return float(err.max()), rel


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


def make_ssd(seed, B, S, H, hd, N, G, dtype, device, *, served=False,
             fused=False, initial_state=False):
    """Inputs of the SSD scan.  The sweep's draws (x 0.5 N(0,1), B and C
    0.4 N(0,1), dt = softplus(N(0,1)), A = -exp(0.3 N(0,1))), or with
    ``served`` the model's decays: A = -exp(a_log) with a_log =
    log(linspace(1, 16, H)) and dt = softplus(N(0,1) + dt_bias), dt_bias drawn
    as ``init_mamba2`` draws it.  With ``fused`` x, B and C are strided slices
    of one conv output (B, S, H*hd + 2GN), as the model passes them."""
    rng = np.random.default_rng(seed)
    di = H * hd
    xbc = rng.standard_normal((B, S, di + 2 * G * N), np.float32)
    xbc[..., :di] *= 0.5
    xbc[..., di:] *= 0.4
    if fused:
        xbc = torch.from_numpy(xbc).to(device=device, dtype=dtype)
        x = xbc[..., :di].view(B, S, H, hd)
        Bm = xbc[..., di:di + G * N].view(B, S, G, N)
        Cm = xbc[..., di + G * N:].view(B, S, G, N)
    else:
        x, Bm, Cm = (torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
                     for a in (xbc[..., :di].reshape(B, S, H, hd),
                               xbc[..., di:di + G * N].reshape(B, S, G, N),
                               xbc[..., di + G * N:].reshape(B, S, G, N)))
    z = rng.standard_normal((B, S, H), np.float32)
    if served:
        A = -np.linspace(1.0, 16.0, H, dtype=np.float32)          # -exp(a_log)
        dt0 = np.exp(rng.random(H) * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
        z = z + np.log(np.expm1(dt0)).astype(np.float32)
    else:
        A = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.3)
    dt = torch.nn.functional.softplus(torch.from_numpy(z)).to(device)
    A = torch.from_numpy(A.astype(np.float32)).to(device)
    h0 = None
    if initial_state:
        h0 = torch.from_numpy(rng.standard_normal((B, H, hd, N), np.float32) * 0.5).to(device)
    return x, dt, A, Bm, Cm, h0


def ssd_bound(args, y, hT):
    """(bound ms, bound_by, flops, bytes) of ``ssd_fwd_work``: the operations
    of the causal half of the two chunk-by-chunk products, C.state^T and the
    state update, against the bytes of every input read once and y and the
    final state written once."""
    x = args[0]
    flops, nbytes = ssd_fwd_work(*args, y, hT)
    t_ops = flops / PEAK_FLOPS[x.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


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
    # per source: registers, shared memory and spills of every instantiation,
    # and any wgmma serialisation ptxas reports (info C75xx "Potential
    # Performance Loss", printed as info, not as a warning)
    out["ptxas"] = {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln or "Performance Loss" in ln
                           or "Function properties for" in ln]
                    for name, log in build.ptxas_log.items()}
    emit(out)


def kernels_flash(dev):
    """The flash-attention kernel against its plain version, both on the card."""
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
    peaked_err, peaked_row_rel = hold("flash_attention main shape, peaked softmax",
                                      got, want, **tol(m["dtype"]),
                                      row_limit=MAIN_ROW_REL_TOL)

    # the main path's shape at the sweep's input scale (near-uniform softmax), timed
    q, k, v = make_qkv(3, m["B"], m["S"], m["S"], m["Hq"], m["Hkv"], m["hd"],
                       m["dtype"], dev)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=True)
    main_err, main_row_rel = hold("flash_attention main shape", got, want, **MAIN_TOL,
                                  row_limit=MAIN_ROW_REL_TOL)
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
    flops, nbytes = flash_fwd_work(q, k, v, got, causal=True)
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
    emit({"phase": "kernels", "kernel": "flash_attention_fwd", "cases": len(cases) + 3,
          "sweep_max_abs_err": {"float32": worst[torch.float32],
                                "bfloat16": worst[torch.bfloat16]},
          "main_shape": entry})
    return entry


# The backward against autograd through flash_attention_plain on the same
# values in fp32, so that the oracle carries no bf16 rounding of its own.  The
# fp32 kernel sums in another order: its gradients agree to a few ulp of the
# largest.  The bf16 kernel rounds P and dS to bf16 for its products (2^-9 of
# each term), takes D = rowsum(dO * O) from the bf16 O, and writes bf16, so a
# gradient is off by a few 2^-9 of its size.  Each of dq, dk, dv is held
#   * elementwise to atol = BWD_ATOL x its largest magnitude + BWD_RTOL x |value|,
#   * as a whole to ||err|| / ||want|| <= BWD_FRO_TOL (Frobenius norms), and
#   * row by row: the largest error of a row over the row's rms (or over 0.1
#     of the gradient's overall rms where the row's is smaller), to BWD_ROW_TOL
#     or to 1.5 times the same measure of flash_attention_bwd_plain on the same
#     inputs (the forward's output and log-sum-exp), whichever is larger.  In
#     bf16 a dq row whose terms nearly cancel (dS sums to 0 over a row's keys)
#     keeps the roundings of P, dS and O at their own size: the plain version,
#     which rounds at the same points, measures 0.054-0.16 on such rows (CPU,
#     the sweep's inputs), and the kernel the same to three digits.
# A key tile or a query head of a group left out moves whole rows by their own
# size, and the whole gradient by some 0.1-0.2 of its norm.
BWD_ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
BWD_RTOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
BWD_FRO_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
BWD_ROW_TOL = {torch.float32: 1e-2, torch.bfloat16: 5e-2}
# llama3.2-1b's training shape: B 4 x S 2048 tokens, 32 / 8 heads of hd 64; and
# the same 240 GFLOP at hd 128 (qwen3 / qwen1.5 / chatglm3's head dim), B 2
TRAIN_SHAPE = dict(B=4, S=2048, Hq=32, Hkv=8, hd=64, dtype=torch.bfloat16, causal=True)
TRAIN_SHAPE_HD128 = dict(TRAIN_SHAPE, B=2, hd=128)


def attention_grads_oracle(q, k, v, do, causal, window=0):
    """(dq, dk, dv) by autograd through flash_attention_plain, in fp32."""
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = flash_attention_plain(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, do.float())


def hold_grads(name, got, want, dtype, plain, names=("dq", "dk", "dv")):
    """Each of dq, dk, dv (or the gradients ``names`` names) against the
    oracle ``want``, the row measure also against ``plain`` (see BWD_ATOL);
    returns the worst (max abs err over the gradient's largest magnitude,
    Frobenius relative error, row measure, the plain version's row
    measure)."""
    worst = [0.0] * 4
    for g_name, a, b, c in zip(names, got, want, plain):
        if a.dtype != dtype:
            raise AssertionError(f"{name} {g_name}: dtype {a.dtype}, expected {dtype}")
        b = b.float()
        scale = float(b.abs().max())
        floor = 0.1 * float(b.pow(2).mean().sqrt())
        fro = float((a.float() - b).norm() / b.norm().clamp_min(1e-30))
        if not fro <= BWD_FRO_TOL[dtype]:
            raise AssertionError(f"{name} {g_name}: ||err|| / ||want|| = {fro:.3e} "
                                 f"(limit {BWD_FRO_TOL[dtype]})")
        rel_plain = row_rel_err(c, b, floor)
        err, rel = hold(f"{name} {g_name}", a, b, atol=BWD_ATOL[dtype] * scale,
                        rtol=BWD_RTOL[dtype],
                        row_limit=max(BWD_ROW_TOL[dtype], 1.5 * rel_plain), row_floor=floor)
        worst = [max(w, x) for w, x in zip(worst, (err / scale, fro, rel, rel_plain))]
    return worst


def attn_pairs(m):
    """(query, key) pairs the attention of shape ``m`` computes
    (``attention_pairs``: with a window the pairs inside it, causal half of
    S x S, else Sq x Sk; ``Sq`` / ``Sk``, or both ``S``)."""
    return attention_pairs(m.get("Sq", m.get("S")), m.get("Sk", m.get("S")), m["causal"],
                           m.get("window") or 0)


def bwd_bounds(m, *tensors):
    """(bound ms, bound_by, bound ms of the kernels' seven products, flops) of
    ``flash_bwd_work``: five products (Q.K^T, dO.V^T, P^T.dO, dS^T.Q, dS.K),
    2.5 times the forward's work, causal halving each (with a window: only
    the pairs inside it), against every input read once (q, k, v, o, dO,
    lse) and dq, dk, dv written once; the kernels recompute Q.K^T and dO.V^T
    for dQ, seven products.  tensors: q, k, v, o, dO, lse, dq, dk, dv."""
    flops, n = flash_bwd_work(*tensors, causal=m["causal"], window=m.get("window") or 0)
    one = flops / 5
    t_bytes = n / PEAK_BYTES_PER_S * 1e3
    t5, t7 = (k * one / PEAK_FLOPS[m["dtype"]] * 1e3 for k in (5, 7))
    return max(t5, t_bytes), ("operations" if t5 >= t_bytes else "bytes"), max(t7, t_bytes), 5 * one


def sdpa_backward_ms(m, q, k, v, do, got, attn_mask=None):
    """Yardstick only: autograd through one library call computing the same
    forward (K/V repeated over the group, as the forward's yardstick does;
    causal or not as ``m`` says, or the boolean ``attn_mask``), its dv
    checked against the kernel's, then timed."""
    rep = m["Hq"] // m["Hkv"]
    leaves = [t.detach().permute(0, 2, 1, 3).requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            leaves[0], leaves[1].repeat_interleave(rep, dim=1),
            leaves[2].repeat_interleave(rep, dim=1), attn_mask=attn_mask,
            is_causal=m["causal"] and attn_mask is None)
    do_h = do.permute(0, 2, 1, 3)
    lib = torch.autograd.grad(lib_out, leaves, do_h, retain_graph=True)
    check_close("library backward vs kernel dv", lib[2].permute(0, 2, 1, 3), got[2],
                atol=BWD_ATOL[m["dtype"]] * 2 * float(got[2].abs().max()), rtol=4e-2)
    return cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do_h, retain_graph=True),
                   warmup=3, reps=15)


def kernels_flash_bwd(dev):
    """The flash-attention backward kernel against autograd through the plain
    forward: the forward's sweep (hd 64 / 80 / 128, GQA 4:1 and 1:1, ragged
    S 1000 / 333 / 257, Sq != Sk) in fp32 and bf16, causal and not, then
    llama3.2-1b's training shape (peaked and near-uniform softmax; two calls
    bit-equal) with timings, the plain backward held to the same oracle, then
    the same training shape at hd 128, timed."""
    worst = {torch.float32: [0.0] * 4, torch.bfloat16: [0.0] * 4}
    n_cases = 0
    for (B, Sq, Sk, Hq, Hkv, hd) in SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = make_qkv(17, B, Sq, Sk, Hq, Hkv, hd, dtype, dev)
                do = make_qkv(18, B, Sq, Sq, Hq, Hq, hd, dtype, dev)[2]
                out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
                got = flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
                torch.cuda.synchronize()
                want = attention_grads_oracle(q, k, v, do, causal)
                plain = flash_attention_bwd_plain(q, k, v, out, do, lse, causal=causal)
                w = hold_grads(f"flash_attention_bwd {(B, Sq, Sk, Hq, Hkv, hd)} {dtype} "
                               f"causal={causal}", got, want, dtype, plain)
                worst[dtype] = [max(a, b) for a, b in zip(worst[dtype], w)]
                n_cases += 1

    m = TRAIN_SHAPE
    shape = (m["B"], m["S"], m["S"], m["Hq"], m["Hkv"], m["hd"])
    # peaked softmax (scores of std 4), as in the forward's check
    q, k, v = make_qkv(25, *shape, m["dtype"], dev, qk_scale=2.0)
    do = make_qkv(26, m["B"], m["S"], m["S"], m["Hq"], m["Hq"], m["hd"], m["dtype"], dev)[2]
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    peaked = hold_grads("flash_attention_bwd training shape, peaked softmax",
                        flash_attention_bwd(q, k, v, out, do, lse, causal=True),
                        attention_grads_oracle(q, k, v, do, True), m["dtype"],
                        flash_attention_bwd_plain(q, k, v, out, do, lse, causal=True))
    # near-uniform softmax, timed
    q, k, v = make_qkv(27, *shape, m["dtype"], dev)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    # no atomics, every item summed in one order: two calls give the same bits
    again = flash_attention_bwd(q, k, v, out, do, lse, causal=True)
    torch.cuda.synchronize()
    for g_name, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"flash_attention_bwd training shape {g_name}: two calls "
                                 f"differ in {int((a != b).sum())} elements")
    del again
    want = attention_grads_oracle(q, k, v, do, True)
    plain_g = flash_attention_bwd_plain(q, k, v, out, do, lse, causal=True)
    main = hold_grads("flash_attention_bwd training shape", got, want, m["dtype"], plain_g)
    # the plain version against the same oracle; its own row measure is the yardstick
    plain = hold_grads("flash_attention_bwd_plain training shape", plain_g, want,
                       m["dtype"], plain_g)
    del plain_g
    kernel_ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, do, lse, causal=True),
                        warmup=3, reps=15)
    plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, out, do, lse, causal=True),
                       warmup=1, reps=3)
    del want

    library_ms = sdpa_backward_ms(m, q, k, v, do, got)
    bound_ms, bound_by, bound7_ms, flops = bwd_bounds(m, q, k, v, out, do, lse, *got)

    # the same work at hd 128 (B 2), near-uniform softmax, timed
    m128 = TRAIN_SHAPE_HD128
    shape128 = (m128["B"], m128["S"], m128["S"], m128["Hq"], m128["Hkv"], m128["hd"])
    q2, k2, v2 = make_qkv(28, *shape128, m128["dtype"], dev)
    do2 = make_qkv(29, m128["B"], m128["S"], m128["S"], m128["Hq"], m128["Hq"], m128["hd"],
                   m128["dtype"], dev)[2]
    out2, lse2 = flash_attention(q2, k2, v2, causal=True, return_lse=True)
    got2 = flash_attention_bwd(q2, k2, v2, out2, do2, lse2, causal=True)
    torch.cuda.synchronize()
    hd128 = hold_grads("flash_attention_bwd hd 128 training shape", got2,
                       attention_grads_oracle(q2, k2, v2, do2, True), m128["dtype"],
                       flash_attention_bwd_plain(q2, k2, v2, out2, do2, lse2, causal=True))
    ms128 = cuda_ms(lambda: flash_attention_bwd(q2, k2, v2, out2, do2, lse2, causal=True),
                    warmup=3, reps=15)
    lib128 = sdpa_backward_ms(m128, q2, k2, v2, do2, got2)
    b128, by128, b7_128, flops128 = bwd_bounds(m128, q2, k2, v2, out2, do2, lse2, *got2)
    del q2, k2, v2, do2, out2, lse2, got2

    entry = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:102",
        "replaces_note": "the gradient of that kernel's function; the Pallas kernel has no "
                         "backward and the JAX package differentiates chunked_attention "
                         "(src/repro/models/attention.py:109)",
        "shape": {k_: (str(v_) if k_ == "dtype" else v_) for k_, v_ in m.items()},
        "launches": None,
        "max_abs_err": main[0], "max_abs_err_is": "over the gradient's largest magnitude",
        "tolerance": {"atol_times_max": BWD_ATOL[m["dtype"]], "rtol": BWD_RTOL[m["dtype"]],
                      "frobenius": BWD_FRO_TOL[m["dtype"]], "row": BWD_ROW_TOL[m["dtype"]]},
        "frobenius_rel_err": main[1], "max_row_err_over_row_rms": main[2],
        "plain_max_row_err_over_row_rms": main[3],
        "peaked_softmax": dict(zip(("max_abs_err", "frobenius_rel_err",
                                    "max_row_err_over_row_rms",
                                    "plain_max_row_err_over_row_rms"), peaked)),
        "plain": dict(zip(("max_abs_err", "frobenius_rel_err"), plain)),
        "two_calls_bit_equal": True,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_7_products_ms": bound7_ms,
        "library_ms": library_ms,
        "library_call": "torch.autograd.grad through scaled_dot_product_attention",
        "tflops": flops / (kernel_ms * 1e-3) / 1e12,
        "hd128": {"shape": {k_: (str(v_) if k_ == "dtype" else v_) for k_, v_ in m128.items()},
                  "ms": ms128, "bound_ms": b128, "bound_by": by128,
                  "bound_7_products_ms": b7_128, "library_ms": lib128,
                  "tflops": flops128 / (ms128 * 1e-3) / 1e12,
                  **dict(zip(("max_abs_err", "frobenius_rel_err", "max_row_err_over_row_rms",
                              "plain_max_row_err_over_row_rms"), hd128))},
    }
    emit({"phase": "kernels", "kernel": "flash_attention_bwd", "cases": n_cases + 3,
          "sweep_worst": {str(k_): dict(zip(("max_abs_err_over_max", "frobenius_rel_err",
                                             "row_measure", "plain_row_measure"), v_))
                          for k_, v_ in worst.items()},
          "training_shape": entry})
    del q, k, v, out, do, lse, got
    torch.cuda.empty_cache()
    return entry


# whisper-medium's attention shapes, bf16, non-causal: its encoder (8
# sequences of 1500 frames, 16 / 16 heads of hd 64) and its cross-attention
# (448 decoder tokens, its training length, against the 1500 encoder
# outputs); and llava-next-34b's training shape (B 4 x S 2048, 56 / 8 heads
# of hd 128, causal: a group of 7 query heads per KV head)
WHISPER_ENC_ATTN = dict(B=8, S=1500, Hq=16, Hkv=16, hd=64, dtype=torch.bfloat16, causal=False)
WHISPER_CROSS_ATTN = dict(B=8, Sq=448, Sk=1500, Hq=16, Hkv=16, hd=64, dtype=torch.bfloat16,
                          causal=False)
LLAVA_TRAIN_ATTN = dict(B=4, S=2048, Hq=56, Hkv=8, hd=128, dtype=torch.bfloat16, causal=True)
# a TP rank's padded heads in the setup phase's case (u): qwen1.5-4b's 20 / 20
# heads over model 8 give 3 a rank, each with its KV head, at a data row's B 4
QWEN_TP_ATTN = dict(B=4, S=2048, Hq=3, Hkv=3, hd=128, dtype=torch.bfloat16, causal=True)
# the launch phase's rank shapes: (a) llama3.2-1b train_4k over data 2 x
# model 2 (a data row's B 1 at a TP rank's 16 / 4 heads), (f) chatglm3-6b
# train_4k without TP (B 1 a rank, 32 query heads over 2 KV heads: a group of
# 16, each dK / dV summed over 16 query heads)
LLAMA_TP_TRAIN_ATTN = dict(B=1, S=4096, Hq=16, Hkv=4, hd=64, dtype=torch.bfloat16,
                           causal=True)
CHATGLM_TRAIN_ATTN = dict(B=1, S=4096, Hq=32, Hkv=2, hd=128, dtype=torch.bfloat16,
                          causal=True)


def attention_case(label, m, seed, dev):
    """Forward and backward kernels at shape ``m`` (with its window, if it
    has one): each against its plain version (the forward with a peaked and
    a near-uniform softmax; the backward against the plain forward and
    backward in fp32 on the same values, and twice bit-equal), timed, beside
    the plain version and the library call (scaled_dot_product_attention,
    and autograd through it; with a window the band as a boolean mask, which
    it cannot skip).  Returns the forward's and the backward's readings."""
    B, Hq, Hkv, hd, dt, causal = (m[k_] for k_ in ("B", "Hq", "Hkv", "hd", "dtype", "causal"))
    Sq, Sk = m.get("Sq", m.get("S")), m.get("Sk", m.get("S"))
    kw = dict(causal=causal, window=m.get("window", 0))
    q, k, v = make_qkv(seed, B, Sq, Sk, Hq, Hkv, hd, dt, dev, qk_scale=2.0)
    peaked = hold(f"flash_attention {label}, peaked softmax", flash_attention(q, k, v, **kw),
                  flash_attention_plain(q, k, v, **kw), **tol(dt), row_limit=MAIN_ROW_REL_TOL)
    q, k, v = make_qkv(seed + 1, B, Sq, Sk, Hq, Hkv, hd, dt, dev)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, **kw)
    f_err, f_row = hold(f"flash_attention {label}", out, want, **MAIN_TOL,
                        row_limit=MAIN_ROW_REL_TOL)
    f_ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), warmup=3, reps=15)
    f_plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), warmup=1, reps=3)
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    kr, vr = kh.repeat_interleave(Hq // Hkv, dim=1), vh.repeat_interleave(Hq // Hkv, dim=1)
    band = band_mask(Sq, kw["window"], dev) if kw["window"] else None
    lib_kw = dict(attn_mask=band) if kw["window"] else dict(is_causal=causal)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    check_close(f"library call vs plain, {label}",
                sdpa(qh, kr, vr, **lib_kw).permute(0, 2, 1, 3), want, **MAIN_TOL)
    f_lib_ms = cuda_ms(lambda: sdpa(qh, kr, vr, **lib_kw), warmup=3, reps=15)
    del kr, vr, want
    lib_name = ("with the band as a boolean attn_mask" if kw["window"] else
                "(causal)" if causal else "(no mask)")
    flops, n = flash_fwd_work(q, k, v, out, causal=causal, window=kw["window"])
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    t_bytes = n / PEAK_BYTES_PER_S * 1e3
    shape = {k_: (str(v_) if k_ == "dtype" else v_) for k_, v_ in m.items()}
    fwd = {"shape": shape, "max_abs_err": f_err, "tolerance": MAIN_TOL,
           "max_row_err_over_row_rms": f_row, "row_err_over_row_rms_limit": MAIN_ROW_REL_TOL,
           "peaked_softmax": {"max_abs_err": peaked[0], "tolerance": tol(dt),
                              "max_row_err_over_row_rms": peaked[1]},
           "ms": f_ms, "plain_ms": f_plain_ms,
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "gflop": flops / 1e9, "library_ms": f_lib_ms,
           "library_call": f"scaled_dot_product_attention {lib_name}",
           "tflops": flops / (f_ms * 1e-3) / 1e12}

    do = make_qkv(seed + 2, B, Sq, Sq, Hq, Hq, hd, dt, dev)[2]
    got = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    again = flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    for g_name, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"flash_attention_bwd {label} {g_name}: two calls differ in "
                                 f"{int((a != b).sum())} elements")
    del again
    # the oracle: the plain forward and backward in fp32 on the same values
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    of, lsef = flash_attention_plain(qf, kf, vf, return_lse=True, **kw)
    want = flash_attention_bwd_plain(qf, kf, vf, of, dof, lsef, **kw)
    del qf, kf, vf, dof, of, lsef
    plain_g = flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
    b_err = hold_grads(f"flash_attention_bwd {label}", got, want, dt, plain_g)
    del plain_g, want
    b_ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, do, lse, **kw), warmup=3, reps=15)
    b_plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, out, do, lse, **kw),
                         warmup=1, reps=3)
    b_lib_ms = sdpa_backward_ms(m, q, k, v, do, got, attn_mask=band)
    b_bound, b_by, b7, b_flops = bwd_bounds(m, q, k, v, out, do, lse, *got)
    bwd = {"shape": shape,
           **dict(zip(("max_abs_err", "frobenius_rel_err", "max_row_err_over_row_rms",
                       "plain_max_row_err_over_row_rms"), b_err)),
           "max_abs_err_is": "over the gradient's largest magnitude",
           "tolerance": {"atol_times_max": BWD_ATOL[dt], "rtol": BWD_RTOL[dt],
                         "frobenius": BWD_FRO_TOL[dt], "row": BWD_ROW_TOL[dt]},
           "oracle": "flash_attention_plain and flash_attention_bwd_plain in fp32",
           "two_calls_bit_equal": True, "ms": b_ms, "plain_ms": b_plain_ms,
           "bound_ms": b_bound, "bound_by": b_by, "bound_7_products_ms": b7,
           "gflop_5_products": b_flops / 1e9, "library_ms": b_lib_ms,
           "library_call": f"torch.autograd.grad through scaled_dot_product_attention {lib_name}",
           "tflops": b_flops / (b_ms * 1e-3) / 1e12}
    del q, k, v, out, lse, do, got, band
    torch.cuda.empty_cache()
    return fwd, bwd


def kernels_flash_cross(dev, fwd_main, bwd_main):
    """The flash kernels at the shapes no other model path gives them:
    whisper's cross-attention (non-causal, Sq 448 != Sk 1500) and encoder
    (non-causal, S 1500 ragged against the tiles), two new entries, and
    llava's training shape (a group of 7 at hd 128), a TP rank's padded
    heads (QWEN_TP_ATTN, the setup phase's case (u)) and the launch phase's
    rank shapes (LLAMA_TP_TRAIN_ATTN, CHATGLM_TRAIN_ATTN), added to the main
    entries ``fwd_main`` / ``bwd_main``."""
    cross_f, cross_b = attention_case("whisper cross shape", WHISPER_CROSS_ATTN, 51, dev)
    enc_f, enc_b = attention_case("whisper encoder shape", WHISPER_ENC_ATTN, 54, dev)
    llava_f, llava_b = attention_case("llava training shape", LLAVA_TRAIN_ATTN, 57, dev)
    fwd_main["llava_training_shape"] = llava_f
    bwd_main["llava_training_shape"] = llava_b
    tp_f, tp_b = attention_case("qwen1.5-4b TP rank shape", QWEN_TP_ATTN, 60, dev)
    fwd_main["tp_rank_shape"] = tp_f
    bwd_main["tp_rank_shape"] = tp_b
    launch = {}
    for name, m, seed in (("llama_train_4k_tp_rank_shape", LLAMA_TP_TRAIN_ATTN, 63),
                          ("chatglm_train_4k_rank_shape", CHATGLM_TRAIN_ATTN, 66)):
        launch[name] = attention_case(name.replace("_", " "), m, seed, dev)
        fwd_main[name], bwd_main[name] = launch[name]
    common = {"route": "cuda", "replaces": "src/repro/kernels/flash_attention.py:102",
              "launches": None,
              "launches_are": "whisper-medium's (24 encoder, 24 self- and 24 "
                              "cross-attention launches a prefill or a step's forward)"}
    fwd = {"name": "flash_attention_fwd_cross", **common,
           "source": "src/repro_torch/csrc/flash_attention.cu", **cross_f,
           "encoder_shape": enc_f}
    bwd = {"name": "flash_attention_bwd_cross", **common,
           "source": "src/repro_torch/csrc/flash_attention_bwd.cu", **cross_b,
           "encoder_shape": enc_b}
    emit({"phase": "kernels", "kernel": "flash_attention cross / encoder / llava",
          "cross": [cross_f, cross_b], "encoder": [enc_f, enc_b],
          "llava_training_shape": [llava_f, llava_b], "tp_rank_shape": [tp_f, tp_b],
          **{k: list(v) for k, v in launch.items()}})
    return [fwd, bwd]


# The sliding window (mixtral's): causal, ragged shapes at each head dim
# against the kernels' tiles (forward 128 x 128 bf16, 16 x 32 fp32; backward
# 128 / 64 bf16 hd 64 / 128, 64 x 64 hd 80, 32 x 32 fp32), windows at and
# around the tile edges, and one longer than the sequence (no key is cut).  A
# window of 63 leaves the last rows of a 128-row q tile nothing to see in the
# tile their walk starts at: those rows run on -1e30 scores until their own
# keys come (csrc/flash_attention.cu, the note at the top).
WINDOW_SWEEP = [(1, 333, 4, 2, 64), (1, 257, 4, 4, 80), (2, 300, 4, 2, 128)]
WINDOWS = (1, 63, 64, 65, 127, 128, 129, None)      # None: S + 7
# mixtral-8x7b's attention at its window's length: one sequence of 8192
# tokens, 32 / 8 heads of hd 128, window 4096
MIXTRAL_ATTN = dict(B=1, S=8192, Hq=32, Hkv=8, hd=128, dtype=torch.bfloat16, causal=True,
                    window=4096)


def band_mask(S, window, dev):
    """(S, S) boolean mask of the causal window: key j seen by query i if
    i - window < j <= i (the library yardstick's attn_mask)."""
    i = torch.arange(S, device=dev)
    return (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)


def kernels_flash_window(dev):
    """The forward and backward kernels with a sliding window against their
    plain versions: the window sweep (fp32 and bf16; the backward against
    autograd through the plain forward, as kernels_flash_bwd), then
    mixtral's attention shape (peaked and near-uniform softmax, the backward
    twice bit-equal), timed, with the plain versions and the library call
    (scaled_dot_product_attention with the band as a boolean mask) beside
    them.  The bounds count only the pairs inside the window."""
    worst_f = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_b = {torch.float32: [0.0] * 4, torch.bfloat16: [0.0] * 4}
    n_cases = 0
    for (B, S, Hq, Hkv, hd) in WINDOW_SWEEP:
        for w in WINDOWS:
            w = w or S + 7
            for dtype in (torch.float32, torch.bfloat16):
                name = f"window {w} {(B, S, Hq, Hkv, hd)} {dtype}"
                q, k, v = make_qkv(43, B, S, S, Hq, Hkv, hd, dtype, dev)
                do = make_qkv(44, B, S, S, Hq, Hq, hd, dtype, dev)[2]
                out, lse = flash_attention(q, k, v, window=w, return_lse=True)
                got = flash_attention_bwd(q, k, v, out, do, lse, window=w)
                torch.cuda.synchronize()
                want = flash_attention_plain(q, k, v, window=w)
                worst_f[dtype] = max(worst_f[dtype], check_close(
                    f"flash_attention {name}", out, want, **tol(dtype)))
                plain = flash_attention_bwd_plain(q, k, v, out, do, lse, window=w)
                want = attention_grads_oracle(q, k, v, do, True, w)
                if w == 1:
                    # a row sees its own key alone: P = 1 and dS = 0, so dq and
                    # dk vanish in exact arithmetic and only their rounding
                    # residue is left; each is held to BWD_ATOL x the largest dv
                    bound = BWD_ATOL[dtype] * float(want[2].abs().max())
                    for g_name, a in (("dq", got[0]), ("dk", got[1])):
                        if not float(a.float().abs().max()) <= bound:
                            raise AssertionError(
                                f"flash_attention_bwd {name} {g_name}: max abs "
                                f"{float(a.float().abs().max()):.3e}, limit {bound:.3e} "
                                f"(zero in exact arithmetic)")
                    r = hold_grads(f"flash_attention_bwd {name}", got[2:], want[2:], dtype,
                                   plain[2:], names=("dv",))
                else:
                    r = hold_grads(f"flash_attention_bwd {name}", got, want, dtype, plain)
                worst_b[dtype] = [max(a, b) for a, b in zip(worst_b[dtype], r)]
                n_cases += 1

    m = MIXTRAL_ATTN
    fwd, bwd = attention_case("mixtral shape", m, 45, dev)
    common = {"route": "cuda", "replaces": "src/repro/kernels/flash_attention.py:102",
              "launches": None, "pairs_in_window": window_pairs(m["S"], m["window"])}
    fwd_entry = {"name": "flash_attention_fwd_window", **common,
                 "source": "src/repro_torch/csrc/flash_attention.cu", **fwd}
    bwd_entry = {"name": "flash_attention_bwd_window", **common,
                 "source": "src/repro_torch/csrc/flash_attention_bwd.cu", **bwd,
                 "launches_are": "the train phase's, mixtral at B 4 x S 2048, where the window "
                                 "of 4096 cuts nothing; the window's cuts run in this entry's "
                                 "check at S 8192"}
    emit({"phase": "kernels", "kernel": "flash_attention window", "cases": n_cases + 2,
          "windows": [w or "S + 7" for w in WINDOWS],
          "sweep_fwd_max_abs_err": {str(k_): v_ for k_, v_ in worst_f.items()},
          "sweep_bwd_worst": {str(k_): dict(zip(("max_abs_err_over_max", "frobenius_rel_err",
                                                 "row_measure", "plain_row_measure"), v_))
                              for k_, v_ in worst_b.items()},
          "mixtral_shape": [fwd_entry, bwd_entry]})
    return [fwd_entry, bwd_entry]


def kernels_ssd(dev):
    """The SSD scan kernel against its plain version, both on the card: y and
    the final state."""
    n_cases = 0
    worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    for (B, S, H, hd, N, G) in SSD_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for h0 in (False, True):
                for fused in (False, True):
                    args = make_ssd(13, B, S, H, hd, N, G, dtype, dev,
                                    fused=fused, initial_state=h0)
                    y, hT = ssd_scan(*args[:5], initial_state=args[5], return_state=True)
                    torch.cuda.synchronize()
                    y_ref, h_ref = ssd_scan_plain(*args[:5], initial_state=args[5],
                                                  return_state=True)
                    name = f"ssd_scan {(B, S, H, hd, N, G)} {dtype} h0={h0} fused={fused}"
                    worst[dtype][0] = max(worst[dtype][0],
                                          check_close(f"{name} y", y, y_ref, **tol(dtype)))
                    worst[dtype][1] = max(worst[dtype][1], check_close(
                        f"{name} final state", hT, h_ref, **SSD_STATE_TOL))
                    n_cases += 1
    # without return_state the kernel writes y alone, and the same y
    args = make_ssd(14, 2, 100, 4, 16, 8, 2, torch.float32, dev)
    if not torch.equal(ssd_scan(*args[:5]), ssd_scan(*args[:5], return_state=True)[0]):
        raise AssertionError("ssd_scan: y depends on return_state")
    # x, B and C as slices of a conv output one element wider, so no row is
    # 16-byte aligned: the bf16 kernel loads them element by element
    x, dt, A, Bm, Cm, _ = make_ssd(15, 2, 150, 4, 64, 64, 1, torch.bfloat16, dev, served=True)
    wide = torch.cat([torch.zeros_like(x[..., 0, :1]), x.flatten(-2), Bm.flatten(-2),
                      Cm.flatten(-2)], dim=-1)
    x, Bm, Cm = (wide[..., a:b].unflatten(-1, (-1, n))
                 for a, b, n in ((1, 257, 64), (257, 321, 64), (321, 385, 64)))
    y, hT = ssd_scan(x, dt, A, Bm, Cm, return_state=True)
    torch.cuda.synchronize()
    y_ref, h_ref = ssd_scan_plain(x, dt, A, Bm, Cm, return_state=True)
    check_close("ssd_scan unaligned rows y", y, y_ref, **tol(torch.bfloat16))
    check_close("ssd_scan unaligned rows final state", hT, h_ref, **SSD_STATE_TOL)
    n_cases += 1

    served = {}
    for arch in SSD_SERVED:
        cfg = get_config(arch)
        shape = dict(B=8, S=2048, H=cfg.ssm_heads, hd=cfg.ssm_headdim, N=cfg.ssm_state,
                     G=cfg.ssm_groups)
        args = make_ssd(21, **shape, dtype=torch.bfloat16, device=dev, served=True,
                        fused=True)
        y, hT = ssd_scan(*args[:5], return_state=True)
        torch.cuda.synchronize()
        y_ref, h_ref = ssd_scan_plain(*args[:5], return_state=True)
        err_y, rel_y = hold(f"ssd_scan {arch} served shape y", y, y_ref, **MAIN_TOL,
                            row_limit=MAIN_ROW_REL_TOL)
        err_h, rel_h = hold(f"ssd_scan {arch} served shape final state", hT, h_ref,
                            **SSD_STATE_TOL, row_limit=MAIN_ROW_REL_TOL)
        n_cases += 1
        kernel_ms = cuda_ms(lambda: ssd_scan(*args[:5], return_state=True), warmup=3, reps=15)
        plain_ms = cuda_ms(lambda: ssd_scan_plain(*args[:5], return_state=True),
                           warmup=1, reps=3)
        bound_ms, bound_by, flops, nbytes = ssd_bound(args, y, hT)
        served[arch] = {
            "shape": {**shape, "dtype": "torch.bfloat16", "inputs": "x, B, C slices of one conv output"},
            "max_abs_err": err_y, "tolerance": MAIN_TOL,
            "max_row_err_over_row_rms": rel_y, "row_err_over_row_rms_limit": MAIN_ROW_REL_TOL,
            "state_max_abs_err": err_h, "state_tolerance": SSD_STATE_TOL,
            "state_max_row_err_over_row_rms": rel_h,
            "y_abs_max": float(y_ref.float().abs().max()),
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "achieved_tflops": flops / (kernel_ms * 1e-3) / 1e12,
        }
    tp_rank = {}
    for arch, B, S, H in SSD_TP_FWD:
        cfg = get_config(arch)
        shape = dict(B=B, S=S, H=H, hd=cfg.ssm_headdim, N=cfg.ssm_state, G=cfg.ssm_groups)
        args = make_ssd(24, **shape, dtype=torch.bfloat16, device=dev, served=True, fused=True)
        y, hT = ssd_scan(*args[:5], return_state=True)
        torch.cuda.synchronize()
        y_ref, h_ref = ssd_scan_plain(*args[:5], return_state=True)
        name = f"ssd_scan {arch} TP rank shape {tuple(shape.values())}"
        err_y, rel_y = hold(f"{name} y", y, y_ref, **MAIN_TOL, row_limit=MAIN_ROW_REL_TOL)
        err_h, _ = hold(f"{name} final state", hT, h_ref, **SSD_STATE_TOL,
                        row_limit=MAIN_ROW_REL_TOL)
        n_cases += 1
        tp_rank[f"{arch} B {B} S {S} H {H}"] = {
            "max_abs_err": err_y, "max_row_err_over_row_rms": rel_y, "state_max_abs_err": err_h,
            "ms": cuda_ms(lambda: ssd_scan(*args[:5], return_state=True), warmup=3, reps=15)}
        del args, y, hT, y_ref, h_ref
    main = served[SSD_SERVED[0]]
    entry = {
        "name": "ssd_scan_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:94",
        "launches": None,
        **{k: main[k] for k in ("shape", "max_abs_err", "tolerance", "max_row_err_over_row_rms",
                                "row_err_over_row_rms_limit", "state_max_abs_err",
                                "state_tolerance", "state_max_row_err_over_row_rms",
                                "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,            # no single PyTorch call computes this function
        "zamba2_shape": served[SSD_SERVED[1]],
    }
    emit({"phase": "kernels", "kernel": "ssd_scan_fwd", "cases": n_cases,
          "sweep_max_abs_err": {str(k): {"y": v[0], "final_state": v[1]}
                                for k, v in worst.items()},
          "served": served, "tp_rank_shapes": tp_rank})
    return entry


def ssd_cotangents(seed, B, S, H, hd, N, dtype, device, final=False):
    """dy (N(0,1) in x's dtype) and, with ``final``, the final state's
    cotangent (N(0,1), fp32)."""
    rng = np.random.default_rng(seed)
    dy = torch.from_numpy(rng.standard_normal((B, S, H, hd), np.float32)).to(device, dtype)
    dh = (torch.from_numpy(rng.standard_normal((B, H, hd, N), np.float32)).to(device)
          if final else None)
    return dy, dh


def hold_ssd_grads(name, got, want, dtype):
    """Each gradient against ``want`` (see SSD_BWD_ATOL); returns {gradient:
    [max abs err over its largest magnitude, Frobenius relative error]}."""
    readings = {}
    for g_name, a, b in zip(SSD_GRADS, got, want):
        if b is None or a is None:
            if (a is None) != (b is None):
                raise AssertionError(f"{name} {g_name}: {a is None} / {b is None} is None")
            continue
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name} {g_name}: {a.dtype} {tuple(a.shape)}, expected "
                                 f"{b.dtype} {tuple(b.shape)}")
        a, b = a.float(), b.float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} {g_name}: non-finite values")
        scale = float(b.abs().max())
        fro = float((a - b).norm() / b.norm().clamp_min(1e-30))
        err = float((a - b).abs().max())
        if g_name in ("ddt", "dA"):
            limit = SSD_BWD_SUM_FRO_TOL
        else:
            lim = torch.float32 if g_name == "dh0" else dtype
            limit = SSD_BWD_FRO_TOL[lim]
            check_close(f"{name} {g_name}", a, b, atol=SSD_BWD_ATOL[lim] * scale,
                        rtol=SSD_BWD_RTOL[lim])
        if not fro <= limit:
            raise AssertionError(f"{name} {g_name}: ||err|| / ||want|| = {fro:.3e} "
                                 f"(limit {limit})")
        readings[g_name] = [err / max(scale, 1e-30), fro]
    return readings


def worst_of(readings):
    """The largest of each reading of ``hold_ssd_grads`` over the gradients."""
    return [max((r[i] for r in readings.values()), default=0.0) for i in (0, 1)]


def merge_readings(into, readings):
    """Per gradient, the largest of each reading so far."""
    for g, r in readings.items():
        into[g] = [max(a, b) for a, b in zip(into.get(g, [0.0, 0.0]), r)]


def ssd_bwd_bound(args, dy, got):
    """(bound ms, bound_by, flops, bytes, scratch bytes): every input (x, dt,
    A, B, C, h0, dy) read once and every gradient written once, against the
    products: the causal halves of C.B^T and dy.x^T and of the three
    chunk-by-chunk products of dx, dB and dC, and five (hd x N) products a
    chunk (dh.B, x^T.dh, dy.h_c, the state and the gradient chains).  The
    scratch (``bwd_scratch``: the chunk states and their gradients, the
    partial dB, dC and dA) belongs to the kernel's design, not to the bytes
    the function must move: it is returned apart and not counted in the
    bound."""
    x, dt, A, Bm, Cm, h0 = args
    Bsz, S, H, hd = x.shape
    N = Bm.shape[3]
    flops, n_bytes = ssd_bwd_work(*args, dy, got)
    t_ops = flops / PEAK_FLOPS[x.dtype] * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    scratch = sum(math.prod(shape) * dtype.itemsize
                  for shape, dtype in bwd_scratch(Bsz, S, H, hd, N, Bm.shape[2], x.dtype).values())
    return (max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops,
            n_bytes, scratch)


def kernels_ssd_bwd(dev):
    """The SSD backward kernel against ssd_scan_bwd_plain, both on the card:
    the forward's sweep (ragged last chunks, G 1 and 2, the bf16 forward's
    tile edges) in fp32 and bf16, with and without an initial state and a
    final-state cotangent, contiguous and as strided slices of one conv
    output; then mamba2's and zamba2's training shapes (the model's decays,
    slices of one conv output, no final-state cotangent as in training; two
    calls bit-equal), timed beside the plain backward and autograd through
    ssd_scan_plain, with the scratch a call allocates and the heads a chunk
    block of the bf16 kernel takes (k)."""
    n_cases = 0
    worst = {torch.float32: {}, torch.bfloat16: {}}
    for (B, S, H, hd, N, G) in SSD_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for h0, final in ((False, False), (True, True), (True, False), (False, True)):
                for fused in (False, True):
                    args = make_ssd(13, B, S, H, hd, N, G, dtype, dev, fused=fused,
                                    initial_state=h0)
                    dy, dh = ssd_cotangents(14, B, S, H, hd, N, dtype, dev, final)
                    got = ssd_scan_bwd(*args[:5], dy, initial_state=args[5],
                                       final_state_grad=dh)
                    torch.cuda.synchronize()
                    want = ssd_scan_bwd_plain(*args[:5], dy, initial_state=args[5],
                                              final_state_grad=dh)
                    merge_readings(worst[dtype], hold_ssd_grads(
                        f"ssd_scan_bwd {(B, S, H, hd, N, G)} {dtype} h0={h0} dhT={final} "
                        f"fused={fused}", got, want, dtype))
                    n_cases += 1

    shapes = {}
    for arch in SSD_SERVED:
        cfg = get_config(arch)
        B, S = TRAIN_SHAPE["B"], TRAIN_SHAPE["S"]        # the train phase's batch
        shape = dict(B=B, S=S, H=cfg.ssm_heads, hd=cfg.ssm_headdim, N=cfg.ssm_state,
                     G=cfg.ssm_groups)
        args = make_ssd(22, **shape, dtype=torch.bfloat16, device=dev, served=True, fused=True)
        dy, _ = ssd_cotangents(23, B, S, shape["H"], shape["hd"], shape["N"],
                               torch.bfloat16, dev)
        got = ssd_scan_bwd(*args[:5], dy)
        # no atomics, every sum in one order: two calls give the same bits
        again = ssd_scan_bwd(*args[:5], dy)
        torch.cuda.synchronize()
        for g_name, a, b in zip(SSD_GRADS, got, again):
            if a is not None and not torch.equal(a, b):
                raise AssertionError(f"ssd_scan_bwd {arch} training shape {g_name}: two calls "
                                     f"differ in {int((a != b).sum())} elements")
        del again
        want = ssd_scan_bwd_plain(*args[:5], dy)
        readings = hold_ssd_grads(f"ssd_scan_bwd {arch} training shape", got, want,
                                  torch.bfloat16)
        err, fro = worst_of(readings)
        del want
        n_cases += 1
        kernel_ms = cuda_ms(lambda: ssd_scan_bwd(*args[:5], dy), warmup=3, reps=15)
        plain_ms = cuda_ms(lambda: ssd_scan_bwd_plain(*args[:5], dy), warmup=1, reps=3)
        # for reference (no single library call computes this function):
        # autograd through the plain forward, its dx checked against the kernel's
        leaves = [t.detach().requires_grad_() for t in args[:5]]
        with torch.enable_grad():
            y = ssd_scan_plain(*leaves)
        auto = torch.autograd.grad(y, leaves, dy, retain_graph=True)
        check_close(f"ssd_scan_bwd {arch}: autograd through the plain forward vs kernel dx",
                    auto[0], got[0], atol=2e-2 * float(got[0].float().abs().max()),
                    rtol=4e-2)
        del auto
        autograd_ms = cuda_ms(lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True),
                              warmup=1, reps=3)
        bound_ms, bound_by, flops, n_bytes, scratch_bytes = ssd_bwd_bound(args, dy, got)
        shapes[arch] = {
            "shape": {**shape, "dtype": "torch.bfloat16",
                      "inputs": "x, B, C slices of one conv output; no final-state cotangent"},
            "max_abs_err": err, "max_abs_err_is": "over the gradient's largest magnitude",
            "frobenius_rel_err": fro, "by_gradient": readings,
            "tolerance": {"atol_times_max": SSD_BWD_ATOL[torch.bfloat16],
                          "rtol": SSD_BWD_RTOL[torch.bfloat16],
                          "frobenius": SSD_BWD_FRO_TOL[torch.bfloat16],
                          "ddt_dA_frobenius": SSD_BWD_SUM_FRO_TOL},
            "two_calls_bit_equal": True,
            "ms": kernel_ms, "plain_ms": plain_ms, "autograd_through_plain_ms": autograd_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            "mbytes": n_bytes / 1e6, "achieved_tflops": flops / (kernel_ms * 1e-3) / 1e12,
            "scratch_mbytes_not_in_bound": scratch_bytes / 1e6,
            "heads_per_block": bwd_heads_per_block(shape["H"], shape["G"]),
        }
        del y, leaves, got, args, dy
        torch.cuda.empty_cache()
    tp_rank = {}
    for arch, B, H in SSD_TP_BWD:
        cfg = get_config(arch)
        shape = dict(B=B, S=2048, H=H, hd=cfg.ssm_headdim, N=cfg.ssm_state, G=cfg.ssm_groups)
        args = make_ssd(25, **shape, dtype=torch.bfloat16, device=dev, served=True, fused=True)
        dy, _ = ssd_cotangents(26, B, 2048, H, shape["hd"], shape["N"], torch.bfloat16, dev)
        got = ssd_scan_bwd(*args[:5], dy)
        again = ssd_scan_bwd(*args[:5], dy)
        torch.cuda.synchronize()
        name = f"ssd_scan_bwd {arch} TP rank shape {tuple(shape.values())}"
        for g_name, a, b in zip(SSD_GRADS, got, again):
            if a is not None and not torch.equal(a, b):
                raise AssertionError(f"{name} {g_name}: two calls differ in "
                                     f"{int((a != b).sum())} elements")
        del again
        readings = hold_ssd_grads(name, got, ssd_scan_bwd_plain(*args[:5], dy), torch.bfloat16)
        err, fro = worst_of(readings)
        n_cases += 1
        tp_rank[f"{arch} B {B} S {S} H {H}"] = {
            "max_abs_err": err, "frobenius_rel_err": fro, "two_calls_bit_equal": True,
            "heads_per_block": bwd_heads_per_block(H, shape["G"]),
            "ms": cuda_ms(lambda: ssd_scan_bwd(*args[:5], dy), warmup=3, reps=15)}
        del args, dy, got
        torch.cuda.empty_cache()
    main = shapes[SSD_SERVED[0]]
    entry = {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:94",
        "replaces_note": "the gradient of that kernel's function; the Pallas kernel has no "
                         "backward and the JAX package differentiates ssd_chunked "
                         "(src/repro/models/ssm.py:100)",
        "launches": None,
        **{k: main[k] for k in ("shape", "max_abs_err", "max_abs_err_is", "frobenius_rel_err",
                                "tolerance", "two_calls_bit_equal", "ms", "plain_ms",
                                "autograd_through_plain_ms", "bound_ms", "bound_by",
                                "achieved_tflops", "scratch_mbytes_not_in_bound",
                                "heads_per_block")},
        "library_ms": None,            # no single PyTorch call computes this function
        "zamba2_shape": shapes[SSD_SERVED[1]],
    }
    emit({"phase": "kernels", "kernel": "ssd_scan_bwd", "cases": n_cases,
          "sweep_worst": {str(k): dict(zip(("max_abs_err_over_max", "frobenius_rel_err"),
                                           worst_of(v)), by_gradient=v)
                          for k, v in worst.items()},
          "training_shapes": shapes, "tp_rank_shapes": tp_rank})
    return entry


def check_equal(name, got, want):
    """Bit-equality of a kernel's output with its plain version."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if not torch.equal(got, want):
        diff = (got.float() - want.float()).abs()
        raise AssertionError(f"{name}: {int((got != want).sum())} of {got.numel()} "
                             f"elements differ; max abs diff {float(diff.max()):.3e}")
    return 0.0


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bytes_bound(work, *ts):
    """(bound ms, "bytes") of ``work(*ts)`` (``tree_reduce_work``,
    ``quantize_work``, ``dequantize_work``): every tensor read or written once
    at the card's memory rate; these kernels do a few operations per
    element."""
    return work(*ts)[1] / PEAK_BYTES_PER_S * 1e3, "bytes"


def randn(gen, shape, dtype, dev, scale=1.0):
    t = torch.empty(shape, dtype=torch.float32, device=dev).normal_(generator=gen)
    return (t * scale).to(dtype)


def served_leaf():
    """Elements of the sync's largest leaf (llama3.2-1b's embedding) and of
    its shard in the (pod, data) mesh."""
    cfg = get_config(SYNC_ARCH)
    n = cfg.padded_vocab * cfg.d_model
    return n, -(-n // SYNC_MESH[0][1])


def kernels_tree(dev, gen):
    """The tree-reduce kernel against its plain version, bit for bit."""
    n_cases = 0
    for N, L in TREE_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(gen, (N, L), dtype, dev, 2.0)
            check_equal(f"tree_reduce {(N, L)} {dtype}", tree_reduce(x), tree_reduce_plain(x))
            n_cases += 1
    # strided batch views: the stacked sync's (P, D_recv, D_src, s) and (1, D, P, s)
    for dtype in (torch.float32, torch.bfloat16):
        x = randn(gen, (2, 4, 4 * 1001), dtype, dev)
        inner = x.view(2, 4, 4, 1001).transpose(1, 2)
        check_equal(f"tree_reduce inner view {dtype}", tree_reduce(inner),
                    tree_reduce_plain(inner))
        outer = x[:, :, :1001].permute(1, 0, 2)[None]
        check_equal(f"tree_reduce outer view {dtype}", tree_reduce(outer),
                    tree_reduce_plain(outer))
        n_cases += 2
    # the served shape: the inner reduce-scatter of the embedding gradient
    (P, D), _ = SYNC_MESH
    _, s = served_leaf()
    x = randn(gen, (P, D, D * s), torch.bfloat16, dev)
    view = x.view(P, D, D, s).transpose(1, 2)
    got = tree_reduce(view)
    torch.cuda.synchronize()
    check_equal("tree_reduce served inner shape", got, tree_reduce_plain(view))
    ms = cuda_ms(lambda: tree_reduce(view), warmup=2, reps=10)
    plain_ms = cuda_ms(lambda: tree_reduce_plain(view), warmup=1, reps=3)

    def library():
        return view.float().sum(-2).to(view.dtype)
    # another summation order: within two bf16 roundings of the values' size
    check_close("tree_reduce library call vs plain", library(), got, atol=2 ** -5, rtol=2 ** -7)
    library_ms = cuda_ms(library, warmup=1, reps=5)
    bound_ms, bound_by = bytes_bound(tree_reduce_work, view, got)
    n_cases += 1
    # the outer reduce of the dequantized payload, (1, D, P, s) fp32
    y = randn(gen, (P, D, s), torch.float32, dev)
    outer = y.permute(1, 0, 2)[None]
    check_equal("tree_reduce served outer shape", tree_reduce(outer), tree_reduce_plain(outer))
    n_cases += 1
    # the setup phase's flat reduce-scatter over data 4 (no pod dimension)
    flat_view = x[0].view(D, D, s).transpose(0, 1)
    check_equal("tree_reduce setup flat shape", tree_reduce(flat_view),
                tree_reduce_plain(flat_view))
    n_cases += 1
    entry = {
        "name": "tree_reduce", "route": "cuda",
        "source": "src/repro_torch/csrc/reduce_tree.cu",
        "replaces": "src/repro/kernels/reduce_tree.py:42",
        "shape": {"view": [P, D, D, s], "reduced_dim": 2, "dtype": "torch.bfloat16",
                  "what": "the inner reduce-scatter of llama3.2-1b's embedding gradient"},
        "launches": None, "max_abs_err": 0.0, "tolerance": "bit-equal",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_call": "shards.float().sum(-2).to(dtype)",
        "gbytes": nbytes(view, got) / 1e9,
    }
    emit({"phase": "kernels", "kernel": "tree_reduce", "cases": n_cases, "main_shape": entry})
    del x, view, got, y, outer, flat_view
    torch.cuda.empty_cache()
    return entry


def tie_case(dev, dtype):
    """A block whose amax is 127 (scale exactly 1) with values k + 0.5: exact
    ties of round(), where half-to-even and floor(x + 0.5) differ."""
    x = torch.arange(64, dtype=torch.float32) - 31.5
    x[0] = 127.0
    return x.to(device=dev, dtype=dtype)


def kernels_quant(dev, gen):
    """The quantize and dequantize kernels against their plain versions, bit
    for bit (q, scales, the residual, the dequantized values)."""
    n_cases = 0
    for n, block in QUANT_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(gen, (n,), dtype, dev, 5.0)
            name = f"quantize {(n, block)} {dtype}"
            got = quantize(x, block, return_error=True)
            want = quantize_plain(x, block, return_error=True)
            for part, a, b in zip(("q", "scales", "err"), got, want):
                check_equal(f"{name} {part}", a, b)
            q2, s2 = quantize(x, block)
            check_equal(f"{name} q without err", q2, got[0])
            for out_dtype in (torch.float32, torch.bfloat16):
                check_equal(f"de{name} -> {out_dtype}",
                            dequantize(got[0], got[1], block, out_dtype=out_dtype),
                            dequantize_plain(got[0], got[1], block, out_dtype=out_dtype))
            n_cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        x = tie_case(dev, dtype)
        q, sc = quantize(x, 64)
        check_equal(f"quantize tie case {dtype}", q, quantize_plain(x, 64)[0])
        body = x[1:].float()
        if float(sc[0]) != 1.0 or not torch.equal(q[1:], torch.round(body).to(torch.int8)) \
                or torch.equal(q[1:], torch.floor(body + 0.5).to(torch.int8)):
            raise AssertionError("quantize tie case: not rounded half to even")
        n_cases += 1
    # rows of a batch, read through a strided view
    wide = randn(gen, (3, 2, 3000), torch.float32, dev)
    rows = wide[:, 1]
    for a, b in zip(quantize(rows, 512, return_error=True),
                    quantize_plain(rows, 512, return_error=True)):
        check_equal("quantize strided rows", a, b)
    n_cases += 1

    # the served shapes: the carry of every replica's embedding shard (R, s)
    # fp32, and the payload gathered across pods, (1, D, P, s) int8
    (P, D), _ = SYNC_MESH
    _, s = served_leaf()
    carry = randn(gen, (P * D, s), torch.float32, dev, 3.0)
    got = quantize(carry, compress.BLOCK, return_error=True)
    torch.cuda.synchronize()
    for part, a, b in zip(("q", "scales", "err"), got,
                          quantize_plain(carry, compress.BLOCK, return_error=True)):
        check_equal(f"quantize served shape {part}", a, b)
    q_ms = cuda_ms(lambda: quantize(carry, compress.BLOCK, return_error=True), warmup=2, reps=10)
    q_plain_ms = cuda_ms(lambda: quantize_plain(carry, compress.BLOCK, return_error=True),
                         warmup=1, reps=3)
    q_bound = bytes_bound(quantize_work, carry, *got)
    qv = got[0].view(P, D, s).permute(1, 0, 2)[None]
    sv = got[1].view(P, D, -1).permute(1, 0, 2)[None]
    deq = dequantize(qv, sv, compress.BLOCK)
    torch.cuda.synchronize()
    check_equal("dequantize served shape", deq, dequantize_plain(qv, sv, compress.BLOCK))
    dq_ms = cuda_ms(lambda: dequantize(qv, sv, compress.BLOCK), warmup=2, reps=10)
    dq_plain_ms = cuda_ms(lambda: dequantize_plain(qv, sv, compress.BLOCK), warmup=1, reps=3)
    dq_bound = bytes_bound(dequantize_work, qv, sv, deq)
    n_cases += 2
    common = {"route": "cuda", "source": "src/repro_torch/csrc/quant8.cu", "launches": None,
              "max_abs_err": 0.0, "tolerance": "bit-equal",
              "library_ms": None,   # no single PyTorch call quantizes blockwise with this scale rule
              }
    q_entry = {"name": "quantize_int8", "replaces": "src/repro/kernels/quant8.py:36", **common,
               "shape": {"x": [P * D, s], "dtype": "torch.float32", "block": compress.BLOCK,
                         "return_error": True,
                         "what": "the error-feedback carry of llama3.2-1b's embedding shards"},
               "ms": q_ms, "plain_ms": q_plain_ms, "bound_ms": q_bound[0],
               "bound_by": q_bound[1], "gbytes": nbytes(carry, *got) / 1e9}
    dq_entry = {"name": "dequantize_int8", "replaces": "src/repro/kernels/quant8.py:55",
                **common,
                "shape": {"q": [1, D, P, s], "out_dtype": "torch.float32",
                          "block": compress.BLOCK,
                          "what": "the payload gathered across pods, a strided view"},
                "ms": dq_ms, "plain_ms": dq_plain_ms, "bound_ms": dq_bound[0],
                "bound_by": dq_bound[1], "gbytes": nbytes(qv, sv, deq) / 1e9}
    emit({"phase": "kernels", "kernel": "quantize_int8 / dequantize_int8", "cases": n_cases,
          "main_shape": {"quantize_int8": q_entry, "dequantize_int8": dq_entry}})
    del carry, got, qv, sv, deq
    torch.cuda.empty_cache()
    return q_entry, dq_entry


def phase_kernels(dev):
    """Every kernel against its plain version, both on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    fwd, bwd = kernels_flash(dev), kernels_flash_bwd(dev)
    return [fwd, bwd, *kernels_flash_cross(dev, fwd, bwd), *kernels_flash_window(dev),
            kernels_ssd(dev), kernels_ssd_bwd(dev), kernels_tree(dev, gen),
            *kernels_quant(dev, gen)]


WRAPPERS = {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd,
            "tree_reduce": tree_reduce, "quantize_int8": quantize,
            "dequantize_int8": dequantize}


def _launches():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def _zero_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")


def attention_launches(cfg):
    """Flash-attention launches of one forward over a prompt: each attention
    block application once; whisper's each encoder layer, and each decoder
    layer twice (self- and cross-attention)."""
    if cfg.family == "audio":
        return cfg.n_enc_layers + 2 * cfg.num_layers
    if cfg.family in ATTN_FAMILIES:
        return cfg.num_layers
    return cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else 0


def expected_launches(cfg):
    """Kernel launches of one prefill: flash attention on every attention
    block application (``attention_launches``), the SSD scan on every Mamba2
    layer (decode runs neither: it reads the KV caches and keeps the O(1) SSM
    recurrence)."""
    none = {name: 0 for name in WRAPPERS}
    if cfg.family in ATTN_FAMILIES:
        return {**none, "flash_attention": attention_launches(cfg)}
    return {**none, "flash_attention": attention_launches(cfg), "ssd_scan": cfg.num_layers}


def expected_sync_launches(mode, n_leaves):
    """Kernel launches of one gradient sync on the stacked transport with an
    outer axis, every leaf non-empty.  Per leaf, flat: one tree reduce (the
    reduce-scatter over every replica); hierarchical: two (the reduce-scatter
    inside the pod, the all-reduce across pods); compressed: two tree reduces
    (the reduce-scatter, the sum of the dequantized payloads), one quantize
    (every replica's carry, with its residual) and one dequantize (the payload
    gathered across pods)."""
    per_leaf = {"flat": {"tree_reduce": 1},
                "hierarchical": {"tree_reduce": 2},
                "compressed": {"tree_reduce": 2, "quantize_int8": 1, "dequantize_int8": 1}}
    return {name: per_leaf[mode].get(name, 0) * n_leaves for name in WRAPPERS}


def model_inputs(cfg, B, seed, patches=None):
    """The batch entries besides the tokens: llava's patch embeddings (B,
    ``patches`` or n_patches, d), whisper's encoder frames (B, enc_seq, d),
    0.02 N(0, 1) as the reference's tests draw them, fp32 numpy; nothing for
    the other families."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"patch_embeds": (rng.standard_normal(
            (B, patches or cfg.n_patches, cfg.d_model), np.float32) * 0.02)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((B, cfg.enc_seq, cfg.d_model), np.float32) * 0.02}
    return {}


def on(extras, where, dtype):
    """``model_inputs``' arrays as tensors on ``where`` in ``dtype``."""
    return {k: torch.from_numpy(a).to(device=where, dtype=dtype) for k, a in extras.items()}


# (arch, layers, batch, prompt length, cache length) of the parity phase:
# llava's prompt follows its 1024 patches, whisper's (2 encoder and 2
# decoder layers) runs against 1500 encoder frames
PARITY = [("llama3.2-1b", 2, 2, 640, 1024), ("mamba2-1.3b", 2, 2, 300, 512),
          ("zamba2-2.7b", 12, 2, 300, 512), ("llava-next-34b", 1, 1, 64, 2048),
          ("whisper-medium", 2, 2, 64, 128)]


def phase_parity(dev):
    """Card (kernel path) against CPU (plain path) on the same weights."""
    for arch, layers, B, S, cache in PARITY:
        cfg = _cut(arch, layers)
        steps = 4
        atol, rtol = 2e-3, 2e-3   # fp32 sums in another order on the two devices
        params = tfm.init(0, cfg, dtype=torch.float32, device=dev)
        params_cpu = tree_map(lambda t: t.cpu(), params)
        rng = np.random.default_rng(1)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + steps)))
        extras = model_inputs(cfg, B, 2)
        enc_fn = _enc_fn(cfg, ParallelConfig())
        errs = []
        with torch.inference_mode():
            _zero_launches()
            lg, st = tfm.prefill(params, {"tokens": toks[:, :S].to(dev),
                                          **on(extras, dev, torch.float32)},
                                 cfg, None, cache, enc_fn=enc_fn)
            used = _launches()
            lc, sc = tfm.prefill(params_cpu, {"tokens": toks[:, :S],
                                              **on(extras, "cpu", torch.float32)},
                                 cfg, None, cache, enc_fn=enc_fn)
            if used != expected_launches(cfg):
                raise AssertionError(f"parity {arch}: prefill launched {used}, expected "
                                     f"{expected_launches(cfg)}")
            if lg.shape != (B, cfg.padded_vocab):
                raise AssertionError(f"parity {arch}: logits shape {tuple(lg.shape)}")
            errs.append(check_close(f"parity {arch} prefill logits", lg.cpu(), lc, atol, rtol))
            for t in range(S, S + steps):
                lg, st = tfm.decode_step(params, toks[:, t:t + 1].to(dev), st, cfg, None)
                lc, sc = tfm.decode_step(params_cpu, toks[:, t:t + 1], sc, cfg, None)
                errs.append(check_close(f"parity {arch} decode step {t - S}", lg.cpu(), lc,
                                        atol, rtol))
            if st.index != sc.index or st.index != S + steps + \
                    extras.get("patch_embeds", np.empty((0, 0))).shape[1]:
                raise AssertionError(f"parity {arch}: index {st.index}, {sc.index}")
            state_errs = {}
            pairs = {"kv.k": (st.kv, sc.kv, "k"), "kv.v": (st.kv, sc.kv, "v"),
                     "shared_kv.k": (st.shared_kv, sc.shared_kv, "k"),
                     "cross_kv.k": (st.cross_kv, sc.cross_kv, "k"),
                     "cross_kv.v": (st.cross_kv, sc.cross_kv, "v"),
                     "ssm.h": (st.ssm, sc.ssm, "h"), "ssm.conv": (st.ssm, sc.ssm, "conv")}
            for name, (a, b, field) in pairs.items():
                if a is not None:
                    state_errs[name] = check_close(f"parity {arch} {name} after decode",
                                                   getattr(a, field).cpu(), getattr(b, field),
                                                   atol, rtol)
        emit({"phase": "parity", "config": f"{arch} full width, {layers} layers, fp32",
              "batch": B, "prompt": S, **{k: a.shape[1] for k, a in extras.items()},
              "decode_steps": steps, "atol": atol, "rtol": rtol,
              "prefill_launches": used, "max_abs_err": max(errs),
              "logit_abs_max": float(lc.abs().max()), "state_max_abs_err": state_errs})
    parity_moe(dev)
    sync_parity(dev)


# mixtral-8x7b in the parity phase: (layers, prompt, cache length), fp32, as
# llama's; and the largest gap between the k-th and the (k+1)-th router
# probability (on the CPU) at which the two devices may choose different
# experts for a token: fp32 sums in another order move a probability by some
# 1e-7, so a flip at a larger gap is a fault
MOE_PARITY = ("mixtral-8x7b", 1, 640, 1024)
ROUTE_TIE_EPS = 1e-5


@contextlib.contextmanager
def patched(module, value=None, **attrs):
    """While active, ``module``'s attributes named in ``attrs`` are replaced
    (the package calls the MoE functions through their module, so one
    replacement reaches every caller); restored on exit.  Yields ``value``."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, new in attrs.items():
        setattr(module, name, new)
    try:
        yield value
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def route_log():
    """While active, records in the list it yields, for every MoE dispatch,
    the experts each token chose (sorted, so the order of a near-tied pair
    does not count), its kept choices (slot >= 0), the gap between its k-th
    and (k+1)-th probability, and the FFN's output; everything moved to the
    CPU."""
    calls = []
    route0, dispatch0, ffn0 = moe._route, moe._dispatch_indices, moe.moe_ffn

    def route(x, router_w, n_experts, top_k):
        out = route0(x, router_w, n_experts, top_k)
        probs = torch.softmax(torch.matmul(x.float(), router_w.float()), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values[..., :top_k + 1]
        calls.append({"experts": torch.sort(out[0], dim=-1).values.cpu(),
                      "gap": (top[..., top_k - 1] - top[..., top_k]).cpu()})
        return out

    def dispatch(expert_idx, n_experts, capacity):
        slot = dispatch0(expert_idx, n_experts, capacity)
        calls[-1]["kept"] = (slot >= 0).sum(dim=-1).cpu()
        return slot

    def ffn(params, x, cfg, **kw):
        out, aux = ffn0(params, x, cfg, **kw)
        calls[-1]["out"] = out.detach().float().cpu()
        return out, aux
    return patched(moe, calls, _route=route, _dispatch_indices=dispatch, moe_ffn=ffn)


def compare_routes(card, cpu, atol, rtol):
    """Per dispatch: tokens whose experts differ between the devices must be
    near-ties on the CPU (gap < ROUTE_TIE_EPS); the FFN outputs are compared
    on the tokens whose experts and kept choices agree.  Returns (routed
    tokens, flipped tokens, largest gap of a flip, tokens compared, max abs
    err of the outputs, {call: rows (groups) whose last token agrees})."""
    routed = flipped = compared = 0
    worst_gap, worst_err, agree_last = 0.0, 0.0, []
    if len(card) != len(cpu):
        raise AssertionError(f"parity moe: {len(card)} dispatches on the card, {len(cpu)} on the CPU")
    for i, (a, b) in enumerate(zip(card, cpu)):
        same = (a["experts"] == b["experts"]).all(dim=-1)          # (G, T)
        routed += same.numel()
        flips = ~same
        if flips.any():
            gaps = b["gap"][flips]
            worst_gap = max(worst_gap, float(gaps.max()))
            if float(gaps.max()) >= ROUTE_TIE_EPS:
                raise AssertionError(f"parity moe dispatch {i}: {int(flips.sum())} tokens chose "
                                     f"other experts at a probability gap up to "
                                     f"{float(gaps.max()):.3e} (limit {ROUTE_TIE_EPS})")
            flipped += int(flips.sum())
        ok = same & (a["kept"] == b["kept"])
        G, T_ = ok.shape
        out_a, out_b = a["out"].reshape(G, T_, -1), b["out"].reshape(G, T_, -1)
        if ok.any():
            worst_err = max(worst_err, check_close(f"parity moe dispatch {i} FFN output",
                                                   out_a[ok], out_b[ok], atol, rtol))
        compared += int(ok.sum())
        agree_last.append(ok[:, -1])
    return routed, flipped, worst_gap, compared, worst_err, agree_last


def parity_moe(dev):
    """mixtral-8x7b at full width, 1 layer, fp32: prefill and 4 decode steps
    on the card (kernels) against the CPU (plain versions), the expert
    choices first (a flip only at a near-tie), then the FFN outputs, the
    logits and the KV cache where the routing agrees."""
    arch, layers, S, cache = MOE_PARITY
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    B, steps = 2, 4
    atol, rtol = 2e-3, 2e-3
    params = tfm.init(0, cfg, dtype=torch.float32, device=dev)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + steps)))
    logs, errs, rows_compared, used = [], [], 0, None
    with torch.inference_mode():
        for where, p in ((dev, params), (torch.device("cpu"), params_cpu)):
            with route_log() as calls:
                _zero_launches()
                lg, st = tfm.prefill(p, {"tokens": toks[:, :S].to(where)}, cfg, None, cache)
                if used is None:
                    used = _launches()
                out = [lg.cpu()]
                for t in range(S, S + steps):
                    lg, st = tfm.decode_step(p, toks[:, t:t + 1].to(where), st, cfg, None)
                    out.append(lg.cpu())
            logs.append((calls, out, st.kv.k.cpu()))
    if used != expected_launches(cfg):
        raise AssertionError(f"parity {arch}: prefill launched {used}, expected "
                             f"{expected_launches(cfg)}")
    (card_calls, card_out, card_k), (cpu_calls, cpu_out, cpu_k) = logs
    routed, flipped, gap, compared, ffn_err, agree = compare_routes(card_calls, cpu_calls,
                                                                    atol, rtol)
    # with one layer a row's logits follow its last token's routing; the
    # dispatches are the prefill's (one group a row) then one a decode step
    for step, (a, b) in enumerate(zip(card_out, cpu_out)):
        rows = agree[step * layers + layers - 1]
        if rows.any():
            errs.append(check_close(f"parity {arch} logits, step {step}", a[rows], b[rows],
                                    atol, rtol))
        rows_compared += int(rows.sum())
    if rows_compared < B * (steps + 1) // 2:
        raise AssertionError(f"parity {arch}: logits of {rows_compared} rows comparable")
    kv_err = check_close(f"parity {arch} kv.k after decode", card_k, cpu_k, atol, rtol)
    emit({"phase": "parity", "config": f"{arch} full width, {layers} layer, fp32",
          "batch": B, "prompt": S, "decode_steps": steps, "atol": atol, "rtol": rtol,
          "prefill_launches": used, "max_abs_err": max(errs),
          "logit_rows_compared": rows_compared, "logit_rows": B * (steps + 1),
          "tokens_routed": routed, "tokens_flipped": flipped,
          "largest_gap_of_a_flip": gap, "route_tie_eps": ROUTE_TIE_EPS,
          "ffn_tokens_compared": compared, "ffn_max_abs_err": ffn_err,
          "logit_abs_max": float(cpu_out[0].abs().max()), "state_max_abs_err": {"kv.k": kv_err}})
    del params, params_cpu
    torch.cuda.empty_cache()


def _shape_tree(params):
    return tree_map(lambda t: tuple(t.shape), params)


def sync_parity(dev):
    """The compressed gradient sync on the card (kernels) against the same
    sync on the CPU (plain versions): the reduced llama3.2-1b tree, fp32,
    every replica drawn from one numpy seed.  Held to one quantum per element
    (the scales of that element's block, summed over the pods, over R) and
    the new error buffers to one scale of their block."""
    cfg = get_config(SYNC_ARCH).reduced()
    shapes = list(_leaves(tfm.init(0, cfg, device="cpu")))
    (P, D), axes = SYNC_MESH
    R = P * D
    rng = np.random.default_rng(3)
    g_np = [rng.standard_normal((R,) + tuple(t.shape), np.float32) for t in shapes]
    e_np = [rng.standard_normal((R, -(-t.numel() // D)), np.float32) * 0.05 for t in shapes]
    results = []                                   # card, then CPU
    for where in (dev, torch.device("cpu")):
        mesh = make_mesh((P, D), axes, device=where)
        g = [torch.from_numpy(a).to(where) for a in g_np]
        e = [torch.from_numpy(a).to(where) for a in e_np]
        _zero_launches()
        out, new = build_sync(mesh, "compressed", "data", "pod")(g, e)
        results.append((out, new, _launches()))
    (card_out, card_err, used), (cpu_out, cpu_err, _) = results
    if used != expected_sync_launches("compressed", len(shapes)):
        raise AssertionError(f"parity sync: launched {used}, expected "
                             f"{expected_sync_launches('compressed', len(shapes))}")
    mesh = make_mesh((P, D), axes, device="cpu")
    worst_q, worst_e, n_diff = 0.0, 0.0, 0
    for i in range(len(shapes)):
        out_c, out_h = card_out[i].cpu(), cpu_out[i]
        err_c, err_h = card_err[i].cpu(), cpu_err[i]
        g, e = torch.from_numpy(g_np[i]), torch.from_numpy(e_np[i])
        xp, _ = _pad_to(mesh.local(g, axes), D)
        carry = ops.reduce_shards(mesh.exchange(xp, ("data",))) + mesh.local(e, axes)
        scales = compress.quantize(carry)[1]                       # (P, D, nb)
        s = carry.shape[-1]
        j = torch.arange(out_h.numel())
        quantum = scales.sum(0)[j // s, (j % s) // compress.BLOCK] / R
        d_out = (out_c.reshape(-1) - out_h.reshape(-1)).abs()
        scale_e = scales.reshape(R, -1).repeat_interleave(compress.BLOCK, 1)[:, :s]
        d_err = (err_c - err_h).abs()
        if not torch.isfinite(out_c).all() or (d_out > quantum + 1e-6).any() or \
                (d_err > scale_e + 1e-6).any():
            raise AssertionError(f"parity sync leaf {i}: max diff {float(d_out.max()):.3e} "
                                 f"(result), {float(d_err.max()):.3e} (error buffer)")
        worst_q = max(worst_q, float((d_out / quantum).max()))
        worst_e = max(worst_e, float((d_err / scale_e).max()))
        n_diff += int((out_c != out_h).sum()) + int((err_c != err_h).sum())
    emit({"phase": "parity", "config": f"{SYNC_ARCH} reduced tree, compressed sync, fp32",
          "mesh": dict(zip(axes, (P, D))), "leaves": len(shapes),
          "elements_per_replica": sum(t.numel() for t in shapes), "launches": used,
          "max_diff_in_quanta": worst_q, "max_error_buffer_diff_in_scales": worst_e,
          "elements_not_bit_equal": n_diff})


# the serve phase's MoE cells: (arch, layers, prompt length of the long batch
# or 0).  mixtral at 16 of its 32 layers (about 47 GB of bf16 weights), then
# two requests past its window of 4096 (the windowed kernel cuts keys on the
# served path, decode wraps the rolling cache); arctic at 2 of 35 layers (an
# expert layer holds 13.4e9 parameters, 26.8 GB in bf16)
SERVE_MOE = [("mixtral-8x7b", 16, 6144), ("arctic-480b", 2, 0)]


def _cut(arch, layers=None):
    """``arch``'s configuration at full width, cut to ``layers`` layers if
    given (an encoder/decoder's encoder too)."""
    cfg = get_config(arch)
    if not layers:
        return cfg
    return dataclasses.replace(cfg, num_layers=layers,
                               n_enc_layers=layers if cfg.n_enc_layers else 0)


def phase_serve(dev, arch, new_tokens=32, layers=None, long_prompt=0):
    """``arch`` (at ``layers`` layers if given) in bf16: 8 requests through
    ``Engine.run_batch`` twice (the launches of each batch asserted, greedy
    and sampled tokens equal between the runs), then, with ``long_prompt``,
    a batch of 2 greedy requests of that prompt length.  Returns the
    launches of the second 8-request batch, or of the long batch if any."""
    cfg = _cut(arch, layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = tfm.init(gen, cfg, dtype=torch.bfloat16, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
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
        _zero_launches()                      # counts of this path only
        done = eng.run_batch(requests(), seed=0)
        launches = _launches()
        for r in done:
            if len(r.output) != new_tokens or \
                    not all(0 <= t < cfg.vocab_size for t in r.output):
                raise AssertionError(f"serve {arch}: request {r.uid} gave {r.output}")
        if eng.nonfinite_logit_rows:
            raise AssertionError(f"serve {arch}: {eng.nonfinite_logit_rows} non-finite logit rows")
        if launches != expected_launches(cfg):
            raise AssertionError(f"serve {arch}: one served batch launched {launches}, "
                                 f"expected {expected_launches(cfg)}")
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
        raise AssertionError(f"serve {arch}: greedy tokens differ between two runs")
    if runs[0]["outputs"] != runs[1]["outputs"]:
        raise AssertionError(f"serve {arch}: sampled tokens differ under the same seed")
    report = {"phase": "serve", "config": cfg.name, "layers": cfg.num_layers,
              "published_layers": get_config(arch).num_layers,
              "dtype": "bfloat16", "parameters": n_params, "requests": 8,
              "prompt_lengths": [int(n) for n in lens], "new_tokens": new_tokens,
              "cache_len": 4096, "sliding_window": cfg.sliding_window,
              "first_run": {k: v for k, v in runs[0].items() if k != "outputs"},
              "second_run": {k: v for k, v in runs[1].items() if k != "outputs"}}
    used = runs[1]["launches"]
    if long_prompt:
        # two prompts past the window: the prefill's kernel launches visit only
        # the key tiles inside each q tile's window, and decode writes the
        # rolling cache at index % window
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        long = [Request(uid=10 + i, prompt=rng.integers(0, cfg.vocab_size, long_prompt).tolist(),
                        max_new_tokens=new_tokens) for i in range(2)]
        done = eng.run_batch(long, seed=0)
        used = _launches()
        if used != expected_launches(cfg):
            raise AssertionError(f"serve {arch}: the long batch launched {used}, expected "
                                 f"{expected_launches(cfg)}")
        for r in done:
            if len(r.output) != new_tokens or \
                    not all(0 <= t < cfg.vocab_size for t in r.output):
                raise AssertionError(f"serve {arch}: long request {r.uid} gave {r.output}")
        if eng.nonfinite_logit_rows:
            raise AssertionError(f"serve {arch}: {eng.nonfinite_logit_rows} non-finite logit "
                                 f"rows in the long batch")
        steps = eng.decode_step_s
        report["long_batch"] = {
            "requests": 2, "prompt": long_prompt, "new_tokens": new_tokens,
            "rolling_cache_slots": min(4096, cfg.sliding_window or 4096),
            "launches": used, "prefill_ms": eng.prefill_s * 1e3,
            "decode_step_ms_p50": statistics.median(steps[1:]) * 1e3,
            "decode_step_ms_max": max(steps[1:]) * 1e3,
            "batch_latency_s": done[0].latency_s,
            "tokens_per_s": sum(len(r.output) for r in done) / done[0].latency_s,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(report)
    del eng, params
    torch.cuda.empty_cache()
    return used


# the serve phase's encoder / patch cells, through tfm.prefill and
# tfm.decode_step (the Engine, as the JAX one, takes text prompts only), as
# (arch, layers or None, text prompt length, cache length): llava at full
# width and 30 of its 60 layers (17.7e9 parameters, 35 GB of bf16; 60 layers,
# 68.8 GB, leave no room for the prefill of 8 x 2048 positions and its cache),
# its 1024 patches before each prompt; whisper at full width and depth
# (1.01e9 parameters), 1500 encoder frames, 224-token prompts and a cache of
# 448, its decoder's context (hf:openai/whisper-medium max_target_positions)
SERVE_PREFIX = [("llava-next-34b", 30, 1024, 4096), ("whisper-medium", None, 224, 448)]


def serve_prefix(dev, arch, layers, prompt, cache_len, new_tokens=32, batch=8):
    """``arch`` (at ``layers`` layers if given) in bf16: ``batch`` greedy
    sequences of ``prompt`` tokens after llava's patches or against
    whisper's frames, prefill then ``new_tokens`` - 1 decode steps, twice;
    the launches of each run (every one in the prefill) asserted, the tokens
    equal between the runs.  Returns the second run's launches."""
    cfg = _cut(arch, layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = tfm.init(gen, cfg, dtype=torch.bfloat16, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt))).to(dev)
    extras = model_inputs(cfg, batch, 1)
    batch_in = {"tokens": toks, **on(extras, dev, torch.bfloat16)}
    enc_fn = _enc_fn(cfg, ParallelConfig())
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()                      # counts of this path only
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, st = tfm.prefill(params, batch_in, cfg, None, cache_len, enc_fn=enc_fn)
            nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
            out = [nxt]
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            steps, finite = [], bool(torch.isfinite(logits).all())
            for _ in range(new_tokens - 1):
                ts = time.perf_counter()
                logits, st = tfm.decode_step(params, nxt, st, cfg, None)
                nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
                out.append(nxt)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - ts)
                finite = finite and bool(torch.isfinite(logits).all())
            total_s = time.perf_counter() - t0
        launches = _launches()
        if launches != expected_launches(cfg):
            raise AssertionError(f"serve {arch}: one batch launched {launches}, expected "
                                 f"{expected_launches(cfg)}")
        if not finite:
            raise AssertionError(f"serve {arch}: non-finite logits")
        want_index = prompt + new_tokens - 1 + (cfg.n_patches if cfg.family == "vlm" else 0)
        if st.index != want_index:
            raise AssertionError(f"serve {arch}: decode state index {st.index}, "
                                 f"expected {want_index}")
        runs.append({"tokens": torch.cat(out, dim=1).cpu(), "launches": launches,
                     "prefill_ms": prefill_s * 1e3,
                     "decode_first_step_ms": steps[0] * 1e3,
                     "decode_step_ms_p50": statistics.median(steps[1:]) * 1e3,
                     "decode_step_ms_max": max(steps[1:]) * 1e3,
                     "batch_latency_s": total_s,
                     "tokens_per_s": batch * new_tokens / total_s,
                     "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
        del st, logits
    if not torch.equal(runs[0]["tokens"], runs[1]["tokens"]):
        raise AssertionError(f"serve {arch}: greedy tokens differ between two runs")
    emit({"phase": "serve", "config": cfg.name, "layers": cfg.num_layers,
          "published_layers": get_config(arch).num_layers,
          "encoder_layers": cfg.n_enc_layers or None, "dtype": "bfloat16",
          "parameters": n_params, "requests": batch, "prompt": prompt,
          **{k: a.shape[1] for k, a in extras.items()}, "new_tokens": new_tokens,
          "cache_len": cache_len, "entry_points": "tfm.prefill, tfm.decode_step (greedy)",
          "first_run": {k: v for k, v in runs[0].items() if k != "tokens"},
          "second_run": {k: v for k, v in runs[1].items() if k != "tokens"},
          "greedy_tokens_equal": True})
    del params, batch_in
    torch.cuda.empty_cache()
    return runs[1]["launches"]


def phase_sync(dev, profile=False):
    """llama3.2-1b's full gradient tree through ``build_sync`` on the stacked
    transport, pod 2 x data 4, in each mode; then the error-feedback property
    on the embedding gradient.  With ``profile``, one more sync of each mode
    runs under torch.profiler (device time by kernel, idle share).  Returns
    the launches of one compressed sync."""
    cfg = get_config(SYNC_ARCH)
    (P, D), axes = SYNC_MESH
    R = P * D
    mesh = make_mesh((P, D), axes, device=dev)
    shapes = _shape_tree(tfm.init(0, cfg, dtype=torch.bfloat16, device=dev))
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    grads = tree_map(lambda shp: torch.empty((R,) + shp, dtype=torch.bfloat16,
                                             device=dev).normal_(generator=gen), shapes)
    g_leaves = list(_leaves(grads))
    n_leaves = len(g_leaves)
    if n_leaves != 2 + 9 * cfg.num_layers:
        raise AssertionError(f"sync: {n_leaves} gradient leaves")
    report = {"phase": "sync", "config": f"{SYNC_ARCH} gradients, bf16, full width and depth",
              "mesh": dict(zip(axes, (P, D))), "leaves": n_leaves,
              "elements_per_replica": sum(g.numel() for g in g_leaves) // R,
              "gradient_bytes": nbytes(*g_leaves), "modes": {}}
    compressed_launches = None
    for mode in MODES:
        sync = build_sync(mesh, mode, "data", "pod")
        errs0 = init_error_feedback(shapes, mesh, "data", "pod") if mode == "compressed" else None
        runs, res = [], None
        for _ in range(3):
            res = None                            # one sync's memory at a time
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_launches()                          # counts of this path only
            t0 = time.perf_counter()
            res = sync(grads, errs0) if mode == "compressed" else sync(grads)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = _launches()
            if launches != expected_sync_launches(mode, n_leaves):
                raise AssertionError(f"sync {mode}: launched {launches}, expected "
                                     f"{expected_sync_launches(mode, n_leaves)}")
            runs.append({"wall_ms": wall_ms,
                         "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
        out, new = res if mode == "compressed" else (res, None)
        worst = 0.0
        for g, o in zip(g_leaves, _leaves(out)):
            if o.shape != g.shape[1:] or o.dtype != g.dtype or not torch.isfinite(o).all():
                raise AssertionError(f"sync {mode}: leaf {tuple(o.shape)} {o.dtype}")
            want = torch.sum(g, 0, dtype=torch.float32) / R
            err = (o.float() - want).abs()
            if mode == "compressed":
                worst = max(worst, float(err.max() / want.abs().max()))
                continue
            # each of the two bf16 roundings (the pod's partial sum, the sum
            # over pods) is at most 2^-8 of its value; /8 is exact
            mag = torch.sum(g.abs(), 0, dtype=torch.float32) / R
            worst = max(worst, float((err / (mag * (2 ** -7 * 1.01) + 1e-30)).max()))
        if profile:
            res = None
            entry_profile = _summarise(*_device_time_by_kernel(
                lambda: sync(grads, errs0) if mode == "compressed" else sync(grads)))
        limit = 0.02 if mode == "compressed" else 1.0
        if worst > limit:
            raise AssertionError(f"sync {mode}: {worst:.4g} against the fp32 mean "
                                 f"(limit {limit})")
        entry = {"runs": runs, "launches": launches,
                 **({"profile": entry_profile} if profile else {}),
                 ("max_err_over_max_abs" if mode == "compressed"
                  else "max_err_over_bf16_rounding_bound"): worst, "limit": limit}
        if mode == "compressed":
            for g, e in zip(g_leaves, _leaves(new)):
                if e.dtype != torch.float32 or \
                        tuple(e.shape) != (R, -(-(g.numel() // R) // D)):
                    raise AssertionError(f"sync: error buffer {tuple(e.shape)} {e.dtype}")
            entry["error_buffer_bytes"] = nbytes(*_leaves(new))
            compressed_launches = launches
        report["modes"][mode] = entry
        del res, out, new, errs0
    del grads, g_leaves
    torch.cuda.empty_cache()

    # error feedback over 20 steps (tests/test_multidevice.py:158-182) on one
    # full-width leaf, fp32 as the reference's test has it
    shape = (R, cfg.padded_vocab, cfg.d_model)
    g = torch.empty(shape, dtype=torch.float32, device=dev).normal_(generator=gen) * 0.1
    sync = build_sync(mesh, "compressed", "data", "pod")
    errs = init_error_feedback({"g": shape[1:]}, mesh)
    exact = g.mean(0)
    acc_c = torch.zeros_like(exact)
    acc_e = torch.zeros_like(exact)
    for _ in range(20):
        out, errs = sync({"g": g}, errs)
        acc_c += out["g"]
        acc_e += exact
    rel = float((acc_c - acc_e).norm() / acc_e.norm())
    if not rel < 5e-3:
        raise AssertionError(f"sync: error feedback over 20 steps, relative error {rel:.3e}")
    report["error_feedback_20_steps"] = {"leaf": list(shape), "dtype": "torch.float32",
                                         "relative_error": rel, "limit": 5e-3}
    emit(report)
    del g, errs, out, exact, acc_c, acc_e
    torch.cuda.empty_cache()
    return compressed_launches


# the train phase: llama3.2-1b, then mamba2-1.3b, at full width and depth,
# B 4 x S 2048 (8192 tokens a step), bf16 params, fp32 master and moments,
# block remat
TRAIN_ARCH = "llama3.2-1b"
TRAIN_STEPS = 4            # then one more after the resume
SSM_TRAIN_ARCH = "mamba2-1.3b"
SSM_TRAIN_STEPS = 3
# mixtral-8x7b at full width, 1 of its 32 layers (1.45e9 parameters a layer,
# about 23 GB a layer with its fp32 master and moments; 2 layers until the
# setup phase's tensor-parallel cases, whose time the cut pays for: the
# 44.3 GB final checkpoint of 2 layers took 61 s to write), 3 steps at B 4 x
# S 2048, where the window of 4096 cuts nothing: the windowed backward's cuts
# are held in the kernels phase at S 8192 (B 1 x S 8192, the same tokens a
# step, ran out of the card's memory in AdamW's update); arctic is not trained
# on one card (one expert layer's optimizer state alone is ~214 GB)
MOE_TRAIN_ARCH = "mixtral-8x7b"
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_STEPS = 3
# card (kernels) against CPU (plain versions) at full width, fp32, as (arch,
# layers, B, S): the same function, products summed in another order on the
# two devices; zamba2 at 12 layers applies its shared block twice; llava's
# 256 text tokens follow TRAIN_PARITY_PATCHES patches (its 1024 would make
# the CPU's side of one layer 4x longer), whisper's run against 1500 frames
TRAIN_PARITY = [("llama3.2-1b", 2, 2, 256), ("mamba2-1.3b", 2, 2, 256),
                ("zamba2-2.7b", 12, 2, 256), ("llava-next-34b", 1, 1, 256),
                ("whisper-medium", 2, 2, 256)]
TRAIN_PARITY_PATCHES = 192
GRAD_FRO_TOL = 1e-4        # ||card - cpu|| / ||cpu|| per gradient leaf
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3   # elementwise: atol x the leaf's largest magnitude


def expected_train_launches(cfg, pcfg):
    """Kernel launches of one train step: each attention's flash forward
    (``attention_launches``) once, again when block remat recomputes it in
    the backward, and its backward once; likewise each Mamba2 layer's SSD
    scan."""
    remat = 1 if pcfg.remat == "none" else 2
    out = {name: 0 for name in WRAPPERS}
    attn = attention_launches(cfg)
    if cfg.family not in ATTN_FAMILIES:
        out.update(ssd_scan=cfg.num_layers * remat, ssd_scan_bwd=cfg.num_layers)
    out.update(flash_attention=attn * remat, flash_attention_bwd=attn)
    return out


def tp_tree_launches(cfg, kind, remat=True, tp=0, seq=False):
    """Tree-reduce launches of one batch row's TP group (its all-reduces over
    ``model``; the data sync apart), ``kind`` train, prefill or decode: the
    lookup's g; g after every attention, cross-attention, MLP and MoE FFN of
    a block (decode: the decoder's blocks only); in training besides the
    loss's all-reduce, block remat's recompute of each block's g but its last
    (the MLP's or the MoE FFN's: ``torch.utils.checkpoint`` stops
    recomputing after the last operation that saved a tensor for the
    backward, and nothing after that g saves one), and f's backward: per
    block the attention's input, the MLP's (a MoE FFN's input and its
    combine weights: two), for a cross-attention its queries and the
    encoder's output, ``q_norm`` / ``k_norm`` per attention with qk-norm, and
    the head's input.  Under expert parallelism each lane of an EP group
    runs these for its own batch row (the lanes' all-to-all is no
    all-reduce).  A Mamba2 block (the ssm and hybrid families) runs two g,
    its gated norm's sum of squares and its output's, the first again in
    remat's recompute, and in the backward four: f's of its input and of the
    norm's mean, and the two gathers' (its in-projection's and its conv
    output's); the hybrid's shared block counts as an attention block at
    each of its applications.

    Heads that do not divide ``tp`` (the degree; 0: they divide): in
    training every attention's gather of its KV (and query) columns adds one
    all-reduce to the backward, and where the query heads do not divide,
    the gather of the heads' outputs another.  ``seq``: the self-attention
    caches in the flash-decoding layout; a decode step then adds two per
    self-attention, the combine's denominators and values (its max is an
    all-gather)."""
    self_attn = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else \
        0 if cfg.family == "ssm" else cfg.num_layers
    extra = 0
    if kind == "decode" and seq:
        extra = 2 * self_attn
    if kind == "train" and tp and cfg.n_kv_heads and cfg.n_kv_heads % tp:
        audio = cfg.family == "audio"
        attentions = self_attn + (cfg.n_enc_layers + cfg.num_layers if audio else 0)
        extra = attentions * (1 + (1 if cfg.n_heads % tp else 0))
    if cfg.family in ("ssm", "hybrid"):
        apps = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else 0
        g_blocks = 2 * cfg.num_layers + 2 * apps
        if kind != "train":
            return 1 + g_blocks + extra
        f = 4 * cfg.num_layers + 2 * apps + (2 * apps if cfg.qk_norm else 0) + 1
        recompute = cfg.num_layers + apps if remat else 0
        return 1 + g_blocks + recompute + 1 + f + extra
    enc = cfg.n_enc_layers if cfg.family == "audio" and kind != "decode" else 0
    cross = cfg.num_layers if cfg.family == "audio" else 0
    g_blocks = 2 * enc + 2 * cfg.num_layers + cross
    if kind != "train":
        return 1 + g_blocks + extra
    attentions = enc + cfg.num_layers + cross
    ffn_f = 2 if cfg.n_experts else 1
    f = 2 * enc + (1 + ffn_f) * cfg.num_layers + 2 * cross + \
        (2 * attentions if cfg.qk_norm else 0) + 1
    recompute = g_blocks - enc - cfg.num_layers if remat else 0
    return 1 + g_blocks + recompute + 1 + f + extra


def flash_ranks(cfg, tp):
    """The ranks of a TP group of degree ``tp`` that run a flash call at an
    attention: every rank, but past the last of the query heads padded to
    ceil(Hq / tp) a rank (20 over 8: 7 ranks)."""
    if not cfg.n_heads:
        return tp
    hp = -(-cfg.n_heads // tp)
    return -(-cfg.n_heads // hp)


def train_flops_per_step(cfg, B, S, P=0):
    """Model FLOPs of one step, recompute not counted: 6 x the parameters
    that enter products (each attention block application's, each Mamba2
    layer's in_proj and out_proj, the head; of a MoE block the router, the
    top-k experts a token runs through and arctic's dense residual: the
    active parameters, not the capacity's padding) x the S positions of the
    decoder (llava's P patch positions among them), plus the attention
    products (forward 2 x 2 x B x S^2 x Hq x hd / 2 causal, with a window only
    the pairs inside it, three times that with the backward) and three times
    each Mamba2 layer's SSD scan products (ssd_bound's count: the causal
    halves of the chunk-by-chunk products, C.state^T and the state update).
    llava: and mm_proj over the P patches.  whisper: and the encoder's
    blocks over its enc_seq frames (attention not causal), and each decoder
    block's cross-attention (q and o over the S positions, k and v over the
    frames, S x enc_seq pairs)."""
    d, hq, hkv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    attn_proj = d * hq * hd * 2 + d * hkv * hd * 2
    attn_block = attn_proj + 3 * d * f
    if cfg.n_experts:
        attn_block = attn_proj + d * cfg.n_experts + \
            cfg.top_k * 3 * d * f + 3 * d * cfg.moe_dense_ff
    scan = 0
    if cfg.family in ATTN_FAMILIES:
        n_attn, matmul_params = cfg.num_layers, cfg.num_layers * attn_block
    else:
        n_attn = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else 0
        di, H, N, G = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
        P = cfg.ssm_headdim
        matmul_params = cfg.num_layers * (d * (2 * di + 2 * G * N + H) + di * d) + \
            n_attn * attn_block
        x, bc = (torch.empty(s_, device="meta") for s_ in ((B, S, H, P), (B, S, G, N)))
        scan = 3 * cfg.num_layers * ssd_fwd_work(x, None, None, bc, bc, None, None, None)[0]
    matmul_params += d * cfg.padded_vocab
    pairs = attention_pairs(S, S, True, cfg.sliding_window)
    attn = 3 * n_attn * 2 * 2 * B * pairs * hq * hd
    extra = 6 * d * d * B * P if cfg.family == "vlm" else 0
    if cfg.family == "audio":
        E, Le, L = cfg.enc_seq, cfg.n_enc_layers, cfg.num_layers
        extra = 6 * Le * attn_block * B * E + 3 * Le * 2 * 2 * B * E * E * hq * hd + \
            6 * L * (d * hq * hd * 2 * B * S + d * hkv * hd * 2 * B * E) + \
            3 * L * 2 * 2 * B * S * E * hq * hd
    return 6 * matmul_params * B * S + attn + scan + extra


def train_f1(dev):
    """Fault F1 on the card: an SSD scan and an attention whose inputs require
    grad go through their autograd Functions, launch their forward and
    backward kernels once each, and give the gradients of the plain
    versions (the scan: ssd_scan_bwd_plain; the attention: autograd through
    flash_attention_plain)."""
    x, dt, A, Bm, Cm, _ = make_ssd(31, 1, 128, 4, 64, 64, 1, torch.bfloat16, dev, served=True)
    leaves = [t.requires_grad_() for t in (x, dt, A, Bm, Cm)]
    dy, _ = ssd_cotangents(32, 1, 128, 4, 64, 64, torch.bfloat16, dev)
    _zero_launches()
    y = ops.ssd(*leaves)
    if y.grad_fn is None or "SSDScan" not in type(y.grad_fn).__name__:
        raise AssertionError(f"ops.ssd under grad: grad_fn {y.grad_fn}")
    ssd_grads = torch.autograd.grad(y, leaves, dy)
    ssd_used = _launches()
    if ssd_used != {**{n: 0 for n in WRAPPERS}, "ssd_scan": 1, "ssd_scan_bwd": 1}:
        raise AssertionError(f"ops.ssd forward + backward launched {ssd_used}")
    if not all(float(g.float().abs().max()) > 0 for g in ssd_grads):
        raise AssertionError("ops.ssd: a gradient is all zero")
    ssd_err = worst_of(hold_ssd_grads(
        "ops.ssd gradient", ssd_grads,
        ssd_scan_bwd_plain(*(t.detach() for t in leaves), dy)[:5], torch.bfloat16))
    q, k, v = (t.requires_grad_() for t in make_qkv(33, 2, 256, 256, 8, 2, 64, torch.bfloat16,
                                                   dev))
    do = make_qkv(34, 2, 256, 256, 8, 8, 64, torch.bfloat16, dev)[2]
    _zero_launches()
    out = ops.attention(q, k, v, causal=True)
    if out.grad_fn is None or "FlashAttention" not in type(out.grad_fn).__name__:
        raise AssertionError(f"ops.attention under grad: grad_fn {out.grad_fn}")
    out.backward(do)
    used = _launches()
    if used["flash_attention"] != 1 or used["flash_attention_bwd"] != 1:
        raise AssertionError(f"ops.attention forward + backward launched {used}")
    grads = [t.grad for t in (q, k, v)]
    if not all(float(g.float().abs().max()) > 0 for g in grads):
        raise AssertionError("ops.attention: a gradient is all zero")
    lse = flash_attention_plain(q.detach(), k.detach(), v.detach(), return_lse=True)[1]
    err = hold_grads("ops.attention gradient", grads,
                     attention_grads_oracle(q, k, v, do, True), torch.bfloat16,
                     flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                               out.detach(), do, lse, causal=True))
    return {"ssd_grad_fn": type(y.grad_fn).__name__, "ssd_launches": ssd_used,
            "ssd_grad_vs_plain": dict(zip(("max_abs_err", "frobenius_rel_err"), ssd_err)),
            "attention_grad_fn": type(out.grad_fn).__name__, "launches": used,
            "attention_grad_abs_max": [float(g.float().abs().max()) for g in grads],
            "attention_grad_vs_plain": dict(zip(("max_abs_err", "frobenius_rel_err",
                                                 "max_row_err_over_row_rms",
                                                 "plain_max_row_err_over_row_rms"), err))}


def train_parity(dev, arch, layers, B, S):
    """``arch`` at full width, ``layers`` layers, fp32: loss and every
    gradient on the card (kernels) against the CPU (plain versions), same
    weights and batch, block remat on both."""
    cfg = _cut(arch, layers)
    pcfg = ParallelConfig(remat="block")
    params = tfm.init(0, cfg, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].clone()}
    batch["labels"][:, :7] = -1                      # masked labels count too
    extras = model_inputs(cfg, B, 3, patches=TRAIN_PARITY_PATCHES)
    results = []
    for where in (dev, torch.device("cpu")):
        leaves, spec = tree_flatten(params)
        live = [p.detach().to(where).requires_grad_() for p in leaves]
        _zero_launches()
        total, metrics = tfm.loss_fn(tree_unflatten(spec, live),
                                     {**{k: t.to(where) for k, t in batch.items()},
                                      **on(extras, where, torch.float32)}, cfg, pcfg,
                                     enc_fn=_enc_fn(cfg, pcfg))
        total.backward()
        results.append((float(total.detach()), [p.grad.cpu() for p in live], _launches(),
                        float(metrics["tokens"])))
        del live, total
    (loss_c, g_c, used, count), (loss_h, g_h, _, count_h) = results
    if used != expected_train_launches(cfg, pcfg):
        raise AssertionError(f"train parity: launched {used}, expected "
                             f"{expected_train_launches(cfg, pcfg)}")
    if count != count_h or count != B * (S - 7):
        raise AssertionError(f"train parity: token counts {count}, {count_h}")
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    if not (np.isfinite(loss_c) and loss_rel <= 1e-5):
        raise AssertionError(f"train parity: loss {loss_c} on the card, {loss_h} on the CPU")
    worst_fro, worst_el = 0.0, 0.0
    for i, (a, b) in enumerate(zip(g_c, g_h)):
        scale = float(b.abs().max())
        fro = float((a - b).norm() / b.norm().clamp_min(1e-30))
        if not fro <= GRAD_FRO_TOL:
            raise AssertionError(f"train parity: gradient leaf {i} {tuple(b.shape)}: "
                                 f"||err|| / ||cpu|| = {fro:.3e} (limit {GRAD_FRO_TOL})")
        worst_el = max(worst_el, check_close(f"train parity gradient leaf {i}", a, b,
                                             atol=GRAD_ATOL * scale, rtol=GRAD_RTOL) / scale)
        worst_fro = max(worst_fro, fro)
    del params
    return {"config": f"{arch} full width, {cfg.num_layers} layers, fp32, block remat",
            "batch": B, "seq": S, **{k: a.shape[1] for k, a in extras.items()},
            "masked_labels": B * 7, "launches": used,
            "loss_card": loss_c, "loss_cpu": loss_h, "loss_rel_err": loss_rel,
            "gradient_leaves": len(g_c), "grad_max_frobenius_rel_err": worst_fro,
            "grad_max_abs_err_over_max": worst_el,
            "tolerance": {"loss_rel": 1e-5, "frobenius": GRAD_FRO_TOL,
                          "atol_times_max": GRAD_ATOL, "rtol": GRAD_RTOL}}


def _trainer_run(dev, card, arch, steps, ckpt_dir, layers=None):
    """``arch`` at full width and depth (or ``layers`` layers) through
    ``Trainer.run()``: bf16 params, fp32 master and moments, block remat,
    TRAIN_SHAPE's batch of SyntheticLM, ``steps`` steps, then the run's final
    checkpoint in ``ckpt_dir``.  Checks the launches of every step, the
    history and the checkpoint's step.  Returns (state, trainer, report, the
    run's launches)."""
    cfg = _cut(arch, layers)
    B, S = TRAIN_SHAPE["B"], TRAIN_SHAPE["S"]
    shape = ShapeConfig("train_4x2048", "train", S, B)
    pcfg = ParallelConfig(remat="block", param_dtype="bfloat16")
    tcfg = TrainerConfig(steps=steps, log_every=1, checkpoint_every=10 ** 9,
                         checkpoint_dir=ckpt_dir)
    tr = Trainer(cfg, shape, pcfg, OptimConfig(), tcfg, device=dev)
    state = tr.init_state()
    n_params = sum(t.numel() for t in _leaves(state.params))
    per_step = []
    step_fn = tr.step_fn

    def counted_step(st, batch):
        before = _launches()
        out = step_fn(st, batch)
        after = _launches()
        per_step.append({k: after[k] - before[k] for k in after})
        return out
    tr.step_fn = counted_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()
    _zero_launches()                              # counts of this path only
    t0 = time.perf_counter()
    state = tr.run(state)                         # ``steps`` steps, then a checkpoint
    run_s = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    want = expected_train_launches(cfg, pcfg)
    if len(per_step) != steps or any(c != want for c in per_step):
        raise AssertionError(f"train {arch}: launches per step {per_step}, expected {want}")
    hist = tr.history
    if [h["step"] for h in hist] != list(range(1, steps + 1)) or \
            not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist):
        raise AssertionError(f"train {arch}: history {hist}")
    if ckpt.latest_step(ckpt_dir) != steps:
        raise AssertionError(f"train {arch}: latest checkpoint {ckpt.latest_step(ckpt_dir)}")
    step_s = statistics.median(h["seconds"] for h in hist[1:])
    flops = train_flops_per_step(cfg, B, S)
    ssm = (f", {cfg.ssm_heads} SSM heads of {cfg.ssm_headdim}, N {cfg.ssm_state}"
           if cfg.family in ("ssm", "hybrid") else "")
    if cfg.n_experts:
        ssm = (f", {cfg.n_experts} experts of d_ff {cfg.d_ff}, top {cfg.top_k}, window "
               f"{cfg.sliding_window}")
    depth = "depth" if cfg.num_layers == get_config(arch).num_layers else \
        f"{cfg.num_layers} of {get_config(arch).num_layers} layers"
    report = {
        "config": f"{cfg.name} full width and {depth} ({cfg.num_layers} layers, d {cfg.d_model}"
                  f"{ssm}, vocab {cfg.vocab_size}), bf16 params, fp32 master and moments, "
                  f"block remat",
        "parameters": n_params, "batch": B, "seq": S, "tokens_per_step": B * S,
        "steps": steps, "losses": [h["loss"] for h in hist],
        "aux_losses": [h["aux_loss"] for h in hist],
        "grad_norms": [h["grad_norm"] for h in hist],
        "step_seconds": [h["seconds"] for h in hist],
        "step_s_median_after_first": step_s,
        "tokens_per_s": B * S / step_s,
        "model_tflop_per_step": flops / 1e12,
        "mfu": flops / step_s / TrainerConfig().peak_flops_per_device,
        "mfu_peak_flops": TrainerConfig().peak_flops_per_device,
        "max_memory_allocated_bytes": peak,
        "memory_allocated_at_start_bytes": allocated_at_start,
        "launches_per_step": per_step[-1], "launches": launches,
        "run_s_with_final_checkpoint": run_s,
        "checkpoint_save_s": run_s - sum(h["seconds"] for h in hist), "card": card,
    }
    return state, tr, report, launches


# the train phase's patch / encoder cells, through make_train_step (the
# Trainer's SyntheticLM, as the JAX one, carries no patches or frames), as
# (arch, layers or None, batch, text tokens), 3 steps, bf16 params, fp32 master
# and moments, block remat: llava at full width and 2 of 60 layers (2.08e9
# parameters), 1024 patches + 1024 tokens (S 2048 split as the JAX
# input_specs splits it); whisper at full width and depth, 1500 frames and
# 448 tokens, its decoder's context
TRAIN_PREFIX = [("llava-next-34b", 2, 4, 1024), ("whisper-medium", None, 8, 448)]
TRAIN_PREFIX_STEPS = 3


def prefix_train_setup(dev, arch, layers, B, S):
    """(cfg, state, step, batch) of a TRAIN_PREFIX cell: the batch in numpy
    (tokens and labels int32, the patches or frames fp32, which the step's
    ``batch_to_device`` casts to the parameters' bf16), drawn from a seed."""
    cfg = _cut(arch, layers)
    pcfg = ParallelConfig(remat="block", param_dtype="bfloat16")
    ocfg = OptimConfig()
    params = tfm.init(0, cfg, dtype=torch.bfloat16, device=dev)
    state = TrainState(params, init_adam(params, ocfg))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], **model_inputs(cfg, B, 5)}
    return cfg, pcfg, state, make_train_step(cfg, pcfg, ocfg), batch


def train_prefix(dev, card, arch, layers, B, S, steps=TRAIN_PREFIX_STEPS):
    """``steps`` train steps of a TRAIN_PREFIX cell on one batch: finite
    losses, the launches of every step asserted, step time, tokens/s, MFU,
    peak memory.  Returns the report and the run's launches."""
    cfg, pcfg, state, step, batch = prefix_train_setup(dev, arch, layers, B, S)
    n_params = sum(t.numel() for t in _leaves(state.params))
    P = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    want = expected_train_launches(cfg, pcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()
    _zero_launches()                              # counts of this path only
    hist = []
    for i in range(steps):
        before = _launches()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])             # waits for the step
        seconds = time.perf_counter() - t0
        after = _launches()
        used = {k: after[k] - before[k] for k in after}
        if used != want:
            raise AssertionError(f"train {arch}: step {i + 1} launched {used}, expected {want}")
        hist.append({"loss": loss, "grad_norm": float(metrics["grad_norm"]),
                     "tokens": float(metrics["tokens"]), "seconds": seconds})
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist):
        raise AssertionError(f"train {arch}: history {hist}")
    if hist[-1]["loss"] > hist[0]["loss"] * 1.05:
        raise AssertionError(f"train {arch}: the loss rose {[h['loss'] for h in hist]}")
    step_s = statistics.median(h["seconds"] for h in hist[1:])
    flops = train_flops_per_step(cfg, B, P + S, P)
    depth = "depth" if cfg.num_layers == get_config(arch).num_layers else \
        f"{cfg.num_layers} of {get_config(arch).num_layers} layers"
    report = {
        "config": f"{cfg.name} full width and {depth} (d {cfg.d_model}, {cfg.n_heads} / "
                  f"{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab {cfg.vocab_size}), bf16 "
                  f"params, fp32 master and moments, block remat, make_train_step",
        "parameters": n_params, "batch": B, "text_tokens": S, "patches": P,
        "frames": cfg.enc_seq if cfg.family == "audio" else 0,
        "encoder_layers": cfg.n_enc_layers or None,
        "decoder_positions_per_step": B * (P + S), "steps": steps,
        "losses": [h["loss"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist],
        "label_tokens": hist[0]["tokens"], "step_seconds": [h["seconds"] for h in hist],
        "step_s_median_after_first": step_s,
        "tokens_per_s": B * (P + S) / step_s,
        "model_tflop_per_step": flops / 1e12,
        "mfu": flops / step_s / TrainerConfig().peak_flops_per_device,
        "mfu_peak_flops": TrainerConfig().peak_flops_per_device,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "memory_allocated_at_start_bytes": allocated_at_start,
        "launches_per_step": want, "launches": _launches(), "card": card}
    launches = report["launches"]
    del state, step, batch
    release()
    return report, launches


def release():
    """Free what the last case left on the card: collect the reference
    cycles that can hold its tensors (the first ``torch.utils.checkpoint``
    call of a process keeps its caller's frames, and with them the parameters
    and gradients of that loss, until the collector runs), then return the
    cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(dev, card):
    """F1 on the card, card against CPU, then llama3.2-1b at full width and
    depth through ``Trainer.run()`` (TRAIN_STEPS steps, its checkpoint, a
    resume, one more step) and mamba2-1.3b likewise (SSM_TRAIN_STEPS steps,
    no resume).  Returns the launches of the main path's runs."""
    report = {"phase": "train", "f1": train_f1(dev)}
    report["parity"] = []
    for case in TRAIN_PARITY:
        report["parity"].append(train_parity(dev, *case))
        release()

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=root)
    try:
        ckpt_dir = os.path.join(ckpt_root, TRAIN_ARCH)
        state, tr, report["run"], launches = _trainer_run(dev, card, TRAIN_ARCH, TRAIN_STEPS,
                                                          ckpt_dir)
        probe = {"final_norm": state.params["final_norm"].float().cpu(),
                 "wq0": state.params["blocks"][0]["attn"]["wq"][:64].float().cpu(),
                 "m_embed": state.opt.m["embed"][:8].cpu()}
        configs = (tr.cfg, tr.shape, tr.pcfg, tr.ocfg,
                   dataclasses.replace(tr.tcfg, steps=TRAIN_STEPS + 1))
        del state, tr
        release()

        # resume: a new trainer finds the checkpoint and takes one more step
        tr2 = Trainer(*configs, device=dev)
        t0 = time.perf_counter()
        state = tr2.resume_or_init()
        resume_s = time.perf_counter() - t0
        if tr2.step != TRAIN_STEPS:
            raise AssertionError(f"train: resumed at step {tr2.step}")
        for name, got in (("final_norm", state.params["final_norm"]),
                          ("wq0", state.params["blocks"][0]["attn"]["wq"][:64]),
                          ("m_embed", state.opt.m["embed"][:8])):
            if not torch.equal(got.float().cpu(), probe[name].float()):
                raise AssertionError(f"train: {name} after the resume differs from the save")
        state = tr2.run(state)
        if tr2.step != TRAIN_STEPS + 1 or not np.isfinite(tr2.history[-1]["loss"]):
            raise AssertionError(f"train: after the resume {tr2.step} {tr2.history}")
        report["run"].update(resume_s=resume_s, step_after_resume=tr2.history[-1])
        del state, tr2
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        release()

        state, tr, report["ssm_run"], ssm_launches = _trainer_run(
            dev, card, SSM_TRAIN_ARCH, SSM_TRAIN_STEPS, os.path.join(ckpt_root, SSM_TRAIN_ARCH))
        del state, tr
        shutil.rmtree(os.path.join(ckpt_root, SSM_TRAIN_ARCH), ignore_errors=True)
        release()

        state, tr, report["moe_run"], moe_launches = _trainer_run(
            dev, card, MOE_TRAIN_ARCH, MOE_TRAIN_STEPS, os.path.join(ckpt_root, MOE_TRAIN_ARCH),
            layers=MOE_TRAIN_LAYERS)
        if not all(h["aux_loss"] > 0 for h in tr.history):
            raise AssertionError(f"train {MOE_TRAIN_ARCH}: aux losses {tr.history}")
        del state, tr
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    release()
    for arch, layers, B, S in TRAIN_PREFIX:
        report[f"{arch}_run"], prefix_launches = train_prefix(dev, card, arch, layers, B, S)
    emit(report)
    return {"flash_attention_bwd": launches["flash_attention_bwd"],
            "ssd_scan_bwd": ssm_launches["ssd_scan_bwd"],
            "flash_attention_bwd_window": moe_launches["flash_attention_bwd"],
            # the last TRAIN_PREFIX cell: whisper's
            "flash_attention_bwd_cross": prefix_launches["flash_attention_bwd"]}


# the parallel phase: every rank of a StackedMesh on the one card.  Expert
# parallelism over data 4 at full width, one MoE layer, B 4 x S 2048 bf16, as
# (arch, with gradients): mixtral (2 experts a rank) forward and backward,
# arctic (32 experts a rank, ~27 GB of experts, its dense residual) forward;
# then llama3.2-1b's 16 blocks as 4 GPipe stages of 4, 8 microbatches of 1 x
# 2048, block remat inside a stage, the embedding and the head with its loss
# outside the pipeline
PARALLEL_EP = [("mixtral-8x7b", True), ("arctic-480b", False)]
PARALLEL_EP_RANKS = 4
PARALLEL_BATCH = (4, 2048)
PIPE_ARCH, PIPE_STAGES, PIPE_MICROBATCHES, PIPE_SEQ = "llama3.2-1b", 4, 8, 2048


def compare(name, got, want):
    """Bit-equality of two runs of one function by two routes, or, where the
    sums ran in another order, ``tol`` of the dtype; returns the readings."""
    got, want = got.detach(), want.detach()
    if torch.equal(got, want):
        return {"bit_equal": True, "max_abs_err": 0.0, "fro_rel": 0.0}
    err = check_close(name, got, want, **tol(want.dtype))
    fro = float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))
    return {"bit_equal": False, "max_abs_err": err, "fro_rel": fro}


def in_turns(a, b):
    """Two routes timed in turns, a b b a: the first call of a process pays
    for what it sets up, and the order shows it."""
    return (a, b, b, a)


def timed(fn):
    """(result, seconds) of ``fn()`` ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def parallel_ep(dev, card, arch, grads):
    """One MoE layer of ``arch`` at full width through ``moe_ep_ffn_fn`` (the
    experts and the batch placed over data by ``shard_leaf``) against
    ``moe_ffn(n_groups=ranks)`` on the same weights and tokens; with
    ``grads``, the gradients of ``sum(out * ct) + aux`` with respect to x and
    every weight too.  Twice each way, timed in turns (``in_turns``)."""
    cfg = get_config(arch)
    n, (B, S), d = PARALLEL_EP_RANKS, PARALLEL_BATCH, cfg.d_model
    mesh = make_mesh((n,), ("data",), device=dev)
    rs = Ruleset(mesh, cfg, ParallelConfig(moe_ep_axis="data"))
    ffn = moe_ep_ffn_fn(rs, cfg)
    expert_spec, batch_spec = rs.spec(("expert", "embed", "mlp")), (rs.batch_axes(B),)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = moe.init_moe(gen, cfg, dtype=torch.bfloat16, device=dev)
    leaves, spec = tree_flatten(params)
    x = randn(gen, (B, S, d), torch.bfloat16, dev)
    ct = randn(gen, (B, S, d), torch.bfloat16, dev)

    def ep(p, xx):
        placed = {**p, **{k: shard_leaf(p[k], expert_spec, mesh)
                          for k in ("w_gate", "w_up", "w_down")}}
        out, aux = ffn(placed, shard_leaf(xx, batch_spec, mesh))
        return out.reshape(B, S, d), aux

    def ref(p, xx):
        return moe.moe_ffn(p, xx, cfg, n_groups=n)

    def run(fn):
        if not grads:
            with torch.no_grad():
                return fn(params, x) + ([],)
        live = [t.detach().requires_grad_() for t in leaves]
        xx = x.detach().requires_grad_()
        out, aux = fn(tree_unflatten(spec, live), xx)
        got = torch.autograd.grad((out.float() * ct).sum() + aux, [xx] + live)
        return out.detach(), aux.detach(), list(got)

    seconds = {"ep": [], "moe_ffn_n_groups": []}
    results = {}
    for name, fn in in_turns(("ep", ep), ("moe_ffn_n_groups", ref)):
        results[name], sec = timed(lambda: run(fn))
        seconds[name].append(sec)
    (out, aux, g), (out_r, aux_r, g_r) = results["ep"], results["moe_ffn_n_groups"]
    if not torch.isfinite(out.float()).all() or out.shape != (B, S, d):
        raise AssertionError(f"parallel {arch}: EP output {tuple(out.shape)} not finite")
    report = {"config": f"{arch} full width, one MoE layer ({cfg.n_experts} experts of d_ff "
                        f"{cfg.d_ff}, top {cfg.top_k}, dense residual {cfg.moe_dense_ff}), bf16",
              "mesh": {"data": n}, "experts_per_rank": cfg.n_experts // n,
              "batch": B, "seq": S, "tokens_per_rank": B * S // n,
              "capacity": moe.capacity_of(B * S // n, cfg),
              "expert_parameters": sum(params[k].numel() for k in ("w_gate", "w_up", "w_down")),
              "out": compare(f"parallel {arch} EP output", out, out_r),
              "aux": [float(aux), float(aux_r)]}
    if float(aux) != float(aux_r):
        check_close(f"parallel {arch} aux", aux, aux_r, atol=1e-6, rtol=1e-5)
    if grads:
        names = ["x"] + ["/".join(map(str, p)) for p in _paths(params)]
        report["grads"] = {nm: compare(f"parallel {arch} gradient {nm}", a, b)
                           for nm, a, b in zip(names, g, g_r)}
    report.update({"forward_backward" if grads else "forward": True,
                   "seconds": seconds,
                   "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                   "card": card})
    return report


def _paths(tree, path=()):
    """The path of every leaf in ``tree_flatten``'s order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path


def parallel_pipeline(dev, card):
    """llama3.2-1b at full width and depth, its blocks as PIPE_STAGES GPipe
    stages (``pipeline_fn`` on a StackedMesh over pipe) against
    ``sequential_reference`` of the same stage function: the pipeline's
    output, the loss of the head over it, and every parameter's gradient
    (embedding, final norm, every block), each through the flash forward and
    backward kernels (launches asserted).  Twice each way, timed in turns
    (``in_turns``).  Returns the pipeline's launches."""
    cfg = get_config(PIPE_ARCH)
    S_st, M, L = PIPE_STAGES, PIPE_MICROBATCHES, PIPE_SEQ
    per = cfg.num_layers // S_st
    pcfg = ParallelConfig(remat="block", param_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    params = tfm.init(0, cfg, dtype=torch.bfloat16, device=dev)
    params["stages"] = stack_stages(params.pop("blocks"), S_st)
    leaves, spec = tree_flatten(params)
    mesh = make_mesh((S_st,), ("pipe",), device=dev)
    positions = torch.arange(L, dtype=torch.int32, device=dev)[None]
    block = tfm._maybe_remat(
        lambda h, bp: apply_attn_block(bp, cfg, pcfg, h, positions=positions)[0], pcfg)

    def stage(p, h):
        for bp in p:
            h = block(h, bp)
        return h
    pipe = pipeline_fn(stage, S_st, M, mesh)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (M, 1, L + 1))).to(dev)
    routes = {
        "pipeline": lambda tree, x: pipe(
            tree_map(lambda t: shard_leaf(t, ("pipe",), mesh), tree["stages"]), x),
        "sequential": lambda tree, x: sequential_reference(stage, tree["stages"], x, S_st)}

    def run(route):
        live = [t.detach().requires_grad_() for t in leaves]
        tree = tree_unflatten(spec, live)
        x_mb = tree["embed"][toks[..., :-1]]                   # (M, 1, L, d)
        h = routes[route](tree, x_mb)
        logits = rms_norm(h.reshape(M, L, -1), tree["final_norm"], cfg.norm_eps) @ \
            tree["embed"].T
        loss, _ = softmax_cross_entropy(logits, toks[..., 1:].reshape(M, L), cfg.vocab_size)
        grads = torch.autograd.grad(loss, live)
        return h.detach(), loss.detach(), list(grads)

    want = {"flash_attention": 2 * cfg.num_layers * M, "flash_attention_bwd": cfg.num_layers * M}
    seconds, results, launches = {r: [] for r in routes}, {}, {}
    for route in in_turns("pipeline", "sequential"):
        _zero_launches()                          # counts of this path only
        results[route], sec = timed(lambda: run(route))
        seconds[route].append(sec)
        launches[route] = _launches()
        used = {k: launches[route][k] for k in want}
        if used != want:
            raise AssertionError(f"parallel pipeline {route}: launched {used}, expected "
                                 f"{want} (forward and remat recompute, backward)")
    (h, loss, g), (h_s, loss_s, g_s) = results["pipeline"], results["sequential"]
    if not torch.isfinite(loss) or h.shape != (M, 1, L, cfg.d_model):
        raise AssertionError(f"parallel pipeline: output {tuple(h.shape)}, loss {float(loss)}")
    names = ["/".join(map(str, p)) for p in _paths(params)]
    report = {
        "config": f"{PIPE_ARCH} full width and depth ({cfg.num_layers} blocks as {S_st} stages "
                  f"of {per}), bf16 params, block remat inside a stage, the embedding and the "
                  f"tied head with its loss outside the pipeline",
        "mesh": {"pipe": S_st}, "microbatches": M, "microbatch": [1, L],
        "ticks": M + S_st - 1, "parameters": sum(t.numel() for t in leaves),
        "out": compare("parallel pipeline output", h, h_s),
        "loss": [float(loss), float(loss_s)],
        "loss_cmp": compare("parallel pipeline loss", loss, loss_s),
        "grads": {nm: compare(f"parallel pipeline gradient {nm}", a, b)
                  for nm, a, b in zip(names, g, g_s)},
        "launches": {r: {k: launches[r][k] for k in want} for r in routes},
        "seconds": seconds,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "card": card}
    report["grads_bit_equal"] = sum(v["bit_equal"] for v in report["grads"].values())
    report["grads_worst_fro_rel"] = max(v["fro_rel"] for v in report["grads"].values())
    return report, launches["pipeline"]


def phase_parallel(dev, card):
    """Expert parallelism (mixtral with gradients, arctic forward) and the
    GPipe pipeline of llama3.2-1b, each against its single-route oracle on
    the card.  Returns the pipeline's launches."""
    report = {"phase": "parallel"}
    for arch, grads in PARALLEL_EP:
        report[f"ep_{arch}"] = parallel_ep(dev, card, arch, grads)
        release()
    report["pipeline"], launches = parallel_pipeline(dev, card)
    release()
    emit(report)
    return launches


# the setup phase: llama3.2-1b at full width and depth, B 8 x S 2048, bf16
# params, the default OptimConfig, block remat, through make_train_setup with
# every rank of a StackedMesh on the card, as (param_sharding, grad_sync, mesh
# shape, axes): (a) zero1 over data 4, flat; (b) replicated over pod 2 x data
# 2, hierarchical; (c) fsdp over data 4, flat; (d) fsdp over pod 2 x data 2 x
# model 1, hierarchical (embed over data alone: the shards summed over pod
# too); each SETUP_STEPS steps from one state, against the one-device
# make_train_step on the whole batch; (c) and (d) also bit for bit against
# the synced gradient and the update of (a) and (b)
SETUP_ARCH = "llama3.2-1b"
SETUP_BATCH = (8, 2048)
SETUP_STEPS = 2
SETUP_CASES = [("zero1", "flat", (4,), ("data",)),
               ("replicated", "hierarchical", (2, 2), ("pod", "data")),
               ("fsdp", "flat", (4,), ("data",)),
               ("fsdp", "hierarchical", (2, 2, 1), ("pod", "data", "model"))]
# the case whose synced gradient and update an fsdp case equals bit for bit:
# the same ranks, the same sync tree
SETUP_TWIN = {"fsdp_flat": "zero1_flat", "fsdp_hierarchical": "replicated_hierarchical",
              "fsdp_flat_tp2": "zero1_flat_tp2"}
SETUP_LOSS_RTOL = 2e-3
# a rank's bf16 gradient and the synced mean are two bf16 roundings of the
# one-device gradient's terms summed in another order: tol(bf16)
SETUP_GRAD_FRO = tol(torch.bfloat16)["rtol"]
# (e) mamba2-1.3b at full width and SETUP_SSM_LAYERS of 48 layers (the cut
# keeps the phase short), fsdp over data 4, flat, one step against the
# one-device step: the SSD kernels through gathered Mamba2 blocks
SETUP_SSM_ARCH, SETUP_SSM_LAYERS = "mamba2-1.3b", 12
# (f) serving through make_setup, fsdp over data 4 (each rank prefills and
# steps its 2 of the 8 requests, every block gathered when it runs), against
# the one-device prefill / decode_step: (arch, prompt, cache length)
SETUP_SERVE = [("llama3.2-1b", 2048, 2048 + 16), ("whisper-medium", 224, 448)]
SETUP_SERVE_MESH = ((4,), ("data",))
SETUP_SERVE_TOKENS = 16
# (g)-(k), tensor parallelism over model: every rank of the TP groups stacked
# on the card, each against the one-device route on the same weights and
# batch.  (g) zero1 over data 2 x model 2, flat, two steps; (h) fsdp over the
# same, two steps, its step 1 bit for bit against (g)'s; (i) fsdp over pod 2
# x data 2 x model 2, hierarchical, one step (llama3.2-1b as (a)-(d))
SETUP_TP_CASES = [("zero1", "flat", (2, 2), ("data", "model"), 2),
                  ("fsdp", "flat", (2, 2), ("data", "model"), 2),
                  ("fsdp", "hierarchical", (2, 2, 2), ("pod", "data", "model"), 1)]
SETUP_TP_LOSS_RTOL = 1e-4
# Under TP a bf16 gradient or logit is rounded otherwise than the one-device
# route's (each rank's partial is rounded before the tree sum), and the two
# differ by two bf16 noises, which leave tol(bf16) for a gradient leaf
# (``python3 tools/tp_rounding.py`` shows it at a reduced width on the CPU,
# and PERF.md's tensor-parallel entry at full width on the card), while each lies as
# far from fp32 as the other.  So a TP case is held against the fp32
# one-device route on the same weights: its error there may be at most
# SETUP_TP_FP32_MARGIN x the one-device bf16 route's (or tol(bf16)'s rtol
# where that is larger).  A rank's missing all-reduce moves a leaf by O(1).
SETUP_TP_FP32_MARGIN = 1.5
# (j) whisper-medium at full width and depth, fsdp over data 2 x model 2,
# trained one step (arch, B, S) and served (prompt, cache) as (f); (k) served
# over data 1 x model 4, fsdp: llama3.2-1b at full depth and llava-next-34b
# at 8 of 60 layers (arch, layers, prompt, cache, patches)
SETUP_TP_MESH = ((2, 2), ("data", "model"))
SETUP_TP_WHISPER = ("whisper-medium", 8, 448, 224, 448)
SETUP_TP4_MESH = ((1, 4), ("data", "model"))
SETUP_TP4_SERVE = [("llama3.2-1b", None, 2048, 2048 + 16, None),
                   ("llava-next-34b", 8, 1024, 1024 + 1024 + 16, 1024)]
# (l)-(o), the MoE family under tensor parallelism over model and expert
# parallelism over data (moe_ep_axis), at full width, bf16, each against the
# one-device route on the same weights.  (l) mixtral-8x7b trained under fsdp
# over data 2 x model 2, two steps (its 8 experts over model, 4 a rank, their
# mlp dim over data); (m) the same model one step under replicated with the
# experts over data (4 a rank) and each expert's mlp dim over model (7168 a
# rank): the setup's all-to-all on the card.  Both at 1 of 32 layers and the
# train phase's B 4 x S 2048, against one one-device oracle.
SETUP_MOE_TRAIN = ("mixtral-8x7b", 1, 4, 2048)         # arch, layers, B, S
SETUP_MOE_TRAIN_CASES = [("fsdp", "", 2), ("replicated", "data", 1)]   # sharding, EP axis, steps
SETUP_MOE_MESH = ((2, 2), ("data", "model"))
# (n) arctic-480b (1 of 35 layers, 13.9e9 parameters, 27.8 GB of bf16) served
# over data 1 x model 2 (64 experts a rank, the dense residual split column /
# row); (o) mixtral-8x7b (4 of 32 layers) served with the experts over data 2
# and their mlp dim over model 2: 8 prompts of 512 tokens, then
# SETUP_MOE_TOKENS decode steps: (arch, layers, prompt, cache, mesh, EP axis)
SETUP_MOE_SERVE = [("arctic-480b", 1, 512, 512 + 8, ((1, 2), ("data", "model")), ""),
                   ("mixtral-8x7b", 4, 512, 512 + 8, SETUP_MOE_MESH, "data")]
SETUP_MOE_TOKENS = 8
# (p)-(s), the SSM and hybrid families under tensor parallelism over model,
# at full width, bf16, each against the one-device route on the same weights
# and batches (B 8 x S 2048), on a line of their own.  (p) mamba2-1.3b at 12
# of 48 layers trained fsdp over data 2 x model 2, two steps (the SSD kernels
# at 32 of 64 heads a rank); (q) zamba2-2.7b at 12 of 54 layers (two
# applications of its shared block) trained one step replicated over data 1
# x model 4 (the SSD kernels at 20 of 80 heads, the backward's k = 5; flash at
# 8 / 8 heads of hd 80): (arch, layers, sharding, mesh, steps)
SETUP_SSM_TRAIN = [("mamba2-1.3b", 12, "fsdp", ((2, 2), ("data", "model")), 2),
                   ("zamba2-2.7b", 12, "replicated", ((1, 4), ("data", "model")), 1)]
# (r) mamba2-1.3b at full depth and (s) zamba2-2.7b at 12 layers served fsdp
# over data 2 x model 2 (SSD at 32 and 40 heads a rank, zamba2's flash at 16 /
# 16): 8 prompts, then SETUP_SERVE_TOKENS decode steps: (arch, layers, prompt,
# cache length)
SETUP_SSM_SERVE = [("mamba2-1.3b", None, 2048, 2048 + SETUP_SERVE_TOKENS),
                   ("zamba2-2.7b", 12, 2048, 2048 + SETUP_SERVE_TOKENS)]


# (t)-(w), heads that do not divide the TP degree and the flash-decoding
# layout of the decode caches, at full width, bf16, each against the
# one-device route on the same weights, on a line of their own.  (t)
# llama3.2-1b at full depth served over data 1 x model 16, the JAX production
# model degree (2 query heads a rank, its 8 KV heads gathered whole, the
# caches' sequence over model): 8 prompts of 1024-2048 tokens left-padded to
# 2048, then SETUP_SERVE_TOKENS steps; (arch, layers, prompt, cache, B, mesh,
# new tokens, prompt lengths)
SETUP_HEADS_SERVE = [
    ("llama3.2-1b", None, 2048, 2048 + 16, 8, ((1, 16), ("data", "model")), 16, (1024, 2048)),
    # (u) qwen1.5-4b (20 query / 20 KV heads: 3 a rank, rank 6 two, rank 7
    # none) at 4 of 40 layers over data 1 x model 8, 8 x 2048, 8 steps
    ("qwen1.5-4b", 4, 2048, 2048 + 8, 8, ((1, 8), ("data", "model")), 8, None),
    # (v) mixtral-8x7b at 2 of 32 layers over data 1 x model 16: 2 prompts of
    # 6144 past its window of 4096, then 16 steps (the rolling cache, its
    # 4096 slots over model)
    ("mixtral-8x7b", 2, 6144, 6144 + 16, 2, ((1, 16), ("data", "model")), 16, None),
    # (w) llama3.2-1b over data 2 x model 2, one sequence of 8192 (B 1, which
    # no data axis divides: the caches' sequence over all four ranks)
    ("llama3.2-1b", None, 8192, 8192 + 16, 1, ((2, 2), ("data", "model")), 16, None)]
# (u) trained: qwen1.5-4b at 4 of 40 layers, fsdp over data 2 x model 8, one
# step at B 8 x S 2048 (the flash backward at a rank's 3 padded heads):
# (arch, layers, sharding, mesh, steps)
SETUP_HEADS_TRAIN = ("qwen1.5-4b", 4, "fsdp", ((2, 8), ("data", "model")), 1)
# (x) Trainer(mesh=) over a train setup, checkpoints of sharded state and the
# elastic resume, on a line of their own: llama3.2-1b at full width and depth,
# B 8 x S 2048 of SyntheticLM, bf16 params, fp32 master and moments, block
# remat.  The one-device Trainer takes steps 1-2 (its checkpoint at 2) and step
# 3; the Trainer over data 2 x model 2 under fsdp takes steps 1-2 (its async
# checkpoint at 2); faults.crash_and_recover tears a save of step 3 and kills
# one rank of four (seed 0): three survivors with model 2 plan to data 1 x
# model 2, which restores step 2 and takes step 3; the one-device Trainer
# resumes the mesh's checkpoint and takes step 3.  (arch, B, S, mesh)
SETUP_TRAINER = ("llama3.2-1b", 8, 2048, ((2, 2), ("data", "model")))


def setup_case_name(sharding, mode, shape):
    """A case's name in the report: its sharding and sync, and ``_tp<n>``
    where the mesh ``shape`` (axis -> size) has a model axis of n > 1."""
    tp = shape.get("model", 1)
    return f"{sharding}_{mode}" + (f"_tp{tp}" if tp > 1 else "")


def setup_batches(cfg, B, S, steps=SETUP_STEPS):
    """``steps`` batches of random tokens, the labels of row r masked with
    probability r / (2 B), so that the ranks' shards count unequal tokens."""
    rng = np.random.default_rng(8)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
        labels = toks[:, 1:].copy()
        labels[rng.random((B, S)) < np.arange(B)[:, None] / (2 * B)] = -1
        out.append({"tokens": toks[:, :-1].copy(), "labels": labels})
    return out


def rank_bytes(trees, sharded):
    """Bytes of the tensors of ``trees`` one rank holds: where ``sharded``
    one row of each leaf's rows form, else every leaf whole."""
    return sum(nbytes(t) // (t.shape[0] if sharded else 1)
               for tree in trees for t in _flat(tree))


def state_bytes_per_rank(state, specs, mesh):
    """Bytes of a decode state one rank holds: each tensor of the state (on
    a ``StackedMesh`` every rank's rows, a cache in the flash-decoding layout
    padded to a multiple of the ranks) over the ranks its spec splits it
    over."""
    is_spec = dict(is_leaf=lambda x: isinstance(x, tuple) and not hasattr(x, "_fields"))
    tensors = [t for t in tree_flatten(state)[0] if torch.is_tensor(t)]
    spec_list = [s for s in tree_flatten(specs, **is_spec)[0] if isinstance(s, tuple) and s]
    return sum(nbytes(t) // math.prod(mesh.shape[a] for e in s if e
                                      for a in ((e,) if isinstance(e, str) else e))
               for t, s in zip(tensors, spec_list))


def _flat(tree):
    """The tensors of ``tree`` in ``tree_flatten``'s order (the specs' order)."""
    return [t for t in tree_flatten(tree)[0] if torch.is_tensor(t)]


def _flat_specs(setup):
    return tree_flatten(setup.param_shardings, is_leaf=lambda x: isinstance(x, tuple))[0]


def _counting_gathers():
    """A patch of ``parallel.steps._gather_fn`` and ``_tp_gather_fn`` (tensor
    parallelism's gather over the data axes) whose gathers count the
    parameter leaves they put together and their bytes; yields the counts."""
    counts = {"gathers": 0, "gathered_bytes": 0}

    def counting(plain):
        def make(*args, **kw):
            gather = plain(*args, **kw)

            def counted(rows, spec):
                full = gather(rows, spec)
                counts["gathers"] += 1
                counts["gathered_bytes"] += nbytes(full)
                return full
            return counted
        return make
    return patched(steps_module, counts, _gather_fn=counting(steps_module._gather_fn),
                   _tp_gather_fn=counting(steps_module._tp_gather_fn))


def setup_gathers_per_step(cfg, rows):
    """Parameter gathers of one fsdp train step: each batch row (a rank, or
    under TP a TP group) gathers the leaves outside the blocks once, and each
    block's leaves, the encoder's too, twice (the forward and block remat's
    recompute)."""
    axes = tfm.param_axes(cfg, stacked=False)
    is_spec = dict(is_leaf=lambda x: isinstance(x, tuple))
    stacks = [axes["blocks"]] + ([axes["encoder"]["blocks"]] if "encoder" in axes else [])
    blocks = sum(len(tree_flatten(b, **is_spec)[0]) for stack in stacks for b in stack)
    every = len(tree_flatten(axes, **is_spec)[0])
    return rows * (every - blocks + 2 * blocks)


def outside_tol(got, want, t):
    """Elements of ``got`` outside ``t`` (atol + rtol x |want|) of ``want``."""
    return int(((got.float() - want.float()).abs() >
                t["atol"] + t["rtol"] * want.float().abs()).sum())


def fro_rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def setup_fp32_grads(cfg, p0, batch, routes=None):
    """The one-device gradient of ``batch`` with ``p0`` in fp32 (block remat),
    the reference a TP case's bf16 gradient and the one-device bf16 one are
    each held against (SETUP_TP_FP32_MARGIN).  A MoE model's routings go to
    ``routes`` (``setup_route_log``)."""
    p32 = tree_map(lambda t: t.float(), p0)
    pcfg = ParallelConfig(remat="block", param_dtype="float32", compute_dtype="float32")
    with setup_route_log(routes):
        g, _ = train_grads(p32, batch, cfg, pcfg, _enc_fn(cfg, pcfg))
    del p32
    return list(_flat(g))


def setup_route_log(calls=None):
    """While active, appends to ``calls`` (when it is a list) each MoE
    routing's experts (sorted per token, (G, T, k)) and router probabilities
    (G, T, E), on the CPU; a routing equal to one already recorded (block
    remat's recompute of it) is left out.  Yields ``calls``."""
    if calls is None:
        return contextlib.nullcontext()
    route0 = moe._route

    def route(x, router_w, n_experts, top_k):
        out = route0(x, router_w, n_experts, top_k)
        with torch.no_grad():
            probs = torch.softmax(torch.matmul(x.float(), router_w.float()), dim=-1).cpu()
        if not any(c["probs"].shape == probs.shape and torch.equal(c["probs"], probs)
                   for c in calls):
            calls.append({"experts": torch.sort(out[0], dim=-1).values.cpu(), "probs": probs})
        return out
    return patched(moe, calls, _route=route)


def compare_setup_routes(name, got, one, ref, group, top_k):
    """The routings of a setup case (``got``: ``group`` consecutive calls, its
    batch rows or EP lanes, make one call of the one-device route) against
    the fp32 one-device route's (``ref``), beside the one-device bf16 route's
    (``one``), by the TP cases' rule for rounding: the router probabilities'
    relative Frobenius error against fp32 at most SETUP_TP_FP32_MARGIN x the
    one-device bf16 route's; a token may choose other experts than the fp32
    route only at a near-tie there (the gap between its k-th and (k+1)-th
    probability below max(ROUTE_TIE_EPS, 2 x SETUP_TP_FP32_MARGIN x the
    one-device bf16 route's largest probability error), counted.  Returns
    (report, per call the tokens (G, T) where the setup's and the one-device
    route's experts both agree with the fp32 route's)."""
    merged = [{"experts": torch.cat([c["experts"] for c in got[i:i + group]]),
               "probs": torch.cat([c["probs"] for c in got[i:i + group]])}
              for i in range(0, len(got), group)]
    if not len(merged) == len(one) == len(ref):
        raise AssertionError(f"{name}: {len(got)} routings in groups of {group}, "
                             f"{len(one)} and {len(ref)} on the one-device routes")
    noise_one = max(float((o["probs"] - r["probs"]).abs().max()) for o, r in zip(one, ref))
    limit = max(ROUTE_TIE_EPS, 2 * SETUP_TP_FP32_MARGIN * noise_one)
    flips = flips_one = tokens = 0
    worst_gap, agree = 0.0, []
    for i, (g, o, r) in enumerate(zip(merged, one, ref)):
        top = torch.sort(r["probs"], dim=-1, descending=True).values
        gap = top[..., top_k - 1] - top[..., top_k]
        moved = (g["experts"] != r["experts"]).any(dim=-1)
        moved_one = (o["experts"] != r["experts"]).any(dim=-1)
        tokens += moved.numel()
        if moved.any():
            worst_gap = max(worst_gap, float(gap[moved].max()))
            if float(gap[moved].max()) >= limit:
                raise AssertionError(f"{name} routing {i}: {int(moved.sum())} tokens chose "
                                     f"other experts than the fp32 route at a probability "
                                     f"gap up to {float(gap[moved].max()):.3e} (limit "
                                     f"{limit:.3e})")
        flips += int(moved.sum())
        flips_one += int(moved_one.sum())
        agree.append(~(moved | moved_one))
    fro = {"setup": max(fro_rel(g["probs"], r["probs"]) for g, r in zip(merged, ref)),
           "one_device_bf16": max(fro_rel(o["probs"], r["probs"]) for o, r in zip(one, ref))}
    if not fro["setup"] <= SETUP_TP_FP32_MARGIN * fro["one_device_bf16"]:
        raise AssertionError(f"{name}: the router probabilities are further from the fp32 "
                             f"route than the one-device bf16 route's allow: {fro}")
    return {"routings": len(merged), "tokens_routed": tokens, "tokens_flipped": flips,
            "tokens_flipped_one_device_bf16": flips_one, "largest_gap_of_a_flip": worst_gap,
            "flip_gap_limit": limit, "route_tie_eps": ROUTE_TIE_EPS,
            "prob_max_abs_err_one_device_bf16": noise_one,
            "prob_fro_rel_worst_vs_fp32": fro}, agree


def _synced_blocks(setup):
    """The blocks the data sync reduces, one tree-reduce stage each: every
    leaf once, a leaf over the TP axis under fsdp once a model block (each
    reduce-scattered over data on its own); an expert leaf held over the EP
    axis none (its gradient is already the lanes' sum, and the smoke's meshes
    have no outer axis to reduce it over)."""
    rs = setup.ruleset
    tp = rs.tp if rs.tp and setup.mesh.shape[rs.tp] > 1 else None
    axes = tree_flatten(tfm.param_axes(setup.cfg, stacked=False),
                        is_leaf=lambda x: isinstance(x, tuple))[0]
    n = 0
    for a, spec in zip(axes, _flat_specs(setup)):
        if rs.ep_axis and "expert" in a:
            continue
        split = tp in [x for e in spec if e for x in ((e,) if isinstance(e, str) else e)]
        n += setup.mesh.shape[tp] if tp and split and setup.pcfg.param_sharding == "fsdp" else 1
    return n


def expert_bytes_per_rank(setup, params):
    """Bytes of the expert leaves one rank holds (one row of each rows form)."""
    axes = tree_flatten(tfm.param_axes(setup.cfg, stacked=False),
                        is_leaf=lambda x: isinstance(x, tuple))[0]
    return sum(nbytes(t[0]) for a, t in zip(axes, _flat(params)) if "expert" in a)


@contextlib.contextmanager
def flash_heads():
    """While active, the (query, KV) head counts of every ``ops.attention``
    call are collected in the set it yields (each flash call of a TP rank
    sees the rank's heads)."""
    heads, plain = set(), ops.attention

    def attention(q, k, v, **kw):
        heads.add((q.shape[2], k.shape[2]))
        return plain(q, k, v, **kw)
    with patched(ops, heads, attention=attention):
        yield heads


@contextlib.contextmanager
def ssd_heads():
    """While active, the head count of every ``ops.ssd`` call is collected in
    the set it yields (each SSD scan of a TP rank sees the rank's heads)."""
    heads, plain = set(), ops.ssd

    def ssd(x, *a, **kw):
        heads.add(x.shape[2])
        return plain(x, *a, **kw)
    with patched(ops, heads, ssd=ssd):
        yield heads


def setup_train_case(dev, card, cfg, p0, batches, want_g, oracle, sharding, mode, mshape,
                     axes, kept=None, steps=SETUP_STEPS, want32=None, ep="", routes=None):
    """One train case of the setup phase: ``steps`` steps through
    ``make_train_setup`` against the one-device losses (``oracle``), step 1's
    synced gradient against the one-device gradient ``want_g`` (under TP:
    against the fp32 one ``want32`` as far as ``want_g`` is); the
    launches of every step asserted, fsdp's gathers counted (asserted).  With
    ``kept``: a twin of SETUP_TWIN keeps its step 1 there, and an fsdp case
    is held bit for bit against its twin's.  ``ep``: the EP axis
    (``moe_ep_axis``).  With ``routes`` (a MoE model's one-device routings,
    ``{"one": bf16, "ref": fp32}``) step 1's routings are held against them
    (``compare_setup_routes``).  Returns (report entry, launches over the
    steps)."""
    B, S = batches[0]["tokens"].shape
    shape = ShapeConfig(f"train_{B}x{S}", "train", S, B)
    ocfg = OptimConfig()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(mshape, axes, device=dev)
    pcfg = ParallelConfig(remat="block", param_dtype="bfloat16", param_sharding=sharding,
                          grad_sync=mode, moe_ep_axis=ep)
    setup = make_train_setup(cfg, shape, mesh, pcfg, ocfg)
    n_rows = mesh.size(setup.ruleset.batch_axes(B))
    fsdp = sharding == "fsdp"
    tp = mesh.shape.get("model", 1) > 1
    want = setup_step_launches(cfg, setup, B)
    name = setup_case_name(sharding, mode, mesh.shape) + (f"_ep_{ep}" if ep else "")
    loss_rtol = SETUP_TP_LOSS_RTOL if tp else SETUP_LOSS_RTOL
    specs = _flat_specs(setup)
    state = setup.init_state(tree_map(lambda t: t.clone(), p0))
    entry = {"param_sharding": sharding, "grad_sync": mode, "layers": cfg.num_layers,
             "mesh": dict(zip(axes, mshape)), "loss": [], "grad_norm": [], "step_s": [],
             "param_bytes_per_rank": rank_bytes([state.params], fsdp or tp or ep),
             "opt_bytes_per_rank": rank_bytes([state.opt.master, state.opt.m, state.opt.v],
                                              sharding != "replicated" or tp or bool(ep))}
    if cfg.n_experts:
        entry["expert_bytes_per_rank"] = expert_bytes_per_rank(setup, state.params)
    used = {k: 0 for k in WRAPPERS}
    gathers, got_routes = [], [] if routes else None
    for i, batch in enumerate(batches[:steps]):
        _zero_launches()                          # counts of this path only
        with _counting_gathers() as counts, flash_heads() as heads, ssd_heads() as s_heads:
            t0 = time.perf_counter()
            if i == 0:                            # the step in its two halves
                with setup_route_log(got_routes):
                    synced, m = setup.grad_fn(state, batch)
                torch.cuda.synchronize()
                entry["grad_fn_s"] = time.perf_counter() - t0
                state, om = setup.update_fn(state, synced)
                m = {**m, **om}
            else:
                state, m = setup.step_fn(state, batch)
            torch.cuda.synchronize()
            entry["step_s"].append(time.perf_counter() - t0)
        gathers.append(dict(counts))
        entry["flash_heads"] = sorted(heads)
        entry["ssd_heads"] = sorted(s_heads)
        got = _launches()
        if got != want:
            raise AssertionError(f"setup {cfg.name} {name} step {i}: launched {got}, "
                                 f"expected {want}")
        for k in used:
            used[k] += got[k]
        if fsdp and counts["gathers"] != setup_gathers_per_step(cfg, n_rows):
            raise AssertionError(f"setup {cfg.name} {name} step {i}: {counts['gathers']} "
                                 f"gathers, expected {setup_gathers_per_step(cfg, n_rows)}")
        loss = float(m["loss"])
        entry["loss"].append(loss)
        entry["grad_norm"].append(float(m["grad_norm"]))
        if not abs(loss - oracle["loss"][i]) <= loss_rtol * abs(oracle["loss"][i]):
            raise AssertionError(f"setup {cfg.name} {name} step {i}: loss {loss} against "
                                 f"the one-device {oracle['loss'][i]} (rtol {loss_rtol})")
        if i > 0:
            continue
        if routes:            # one layer: a batch row's (lane's) routing once
            entry["routing"], _ = compare_setup_routes(
                f"setup {cfg.name} {name}", got_routes, routes["one"], routes["ref"], n_rows,
                cfg.top_k)
        whole = ([unshard_leaf(r, s, mesh) for r, s in zip(_flat(synced), specs)]
                 if fsdp or tp or ep else list(_flat(synced)))
        worst = max(fro_rel(a, b) for a, b in zip(whole, _flat(want_g)))
        entry["grad_fro_rel_worst"] = worst
        if tp:       # counted, not asserted: the ranks' partials round apart
            entry["grad_outside_tol_bf16"] = sum(
                outside_tol(a, b, tol(torch.bfloat16)) for a, b in zip(whole, _flat(want_g)))
            entry["grad_elements"] = sum(a.numel() for a in whole)
            tp32 = max(fro_rel(a, w) for a, w in zip(whole, want32))
            one32 = max(fro_rel(b, w) for b, w in zip(_flat(want_g), want32))
            limit = max(SETUP_GRAD_FRO, SETUP_TP_FP32_MARGIN * one32)
            entry["grad_fro_rel_worst_vs_fp32"] = {"tp": tp32, "one_device_bf16": one32,
                                                   "limit": limit}
            if not tp32 <= limit:
                raise AssertionError(f"setup {cfg.name} {name}: a synced gradient leaf is "
                                     f"{tp32:.3e} off the fp32 one (the one-device bf16 "
                                     f"route {one32:.3e}; limit {limit:.3e})")
        elif not worst <= SETUP_GRAD_FRO:
            raise AssertionError(f"setup {cfg.name} {name}: a synced gradient leaf is "
                                 f"{worst:.3e} off the one-device one (limit {SETUP_GRAD_FRO})")
        if kept is not None and name in SETUP_TWIN.values():
            kept[name] = {"grads": synced, "mesh": mesh,
                          "params": tree_map(lambda t: t.clone(), state.params)}
            if tp:            # both whole, for a twin placed otherwise
                kept[name]["grads"] = whole
                kept[name]["params"] = [unshard_leaf(r, s, mesh).clone()   # not a view:
                                        for r, s in zip(_flat(state.params), specs)]  # step 2
            if sharding == "zero1" and not tp:
                kept[name]["master"] = tree_map(lambda t: t.clone(), state.opt.master)
                kept[name]["specs"] = tree_flatten(setup.state_shardings.opt.master,
                                                   is_leaf=lambda x: isinstance(x, tuple))[0]
        del whole
        if kept is not None and name in SETUP_TWIN:
            twin = kept[SETUP_TWIN[name]]
            if tp:
                same_g = [torch.equal(unshard_leaf(r, s, mesh), g)
                          for r, g, s in zip(_flat(synced), twin["grads"], specs)]
            else:
                same_g = [torch.equal(r, shard_leaf(g, s, mesh))
                          for r, g, s in zip(_flat(synced), _flat(twin["grads"]), specs)]
            same_p = [torch.equal(unshard_leaf(r, s, mesh), p)
                      for r, p, s in zip(_flat(state.params), _flat(twin["params"]), specs)]
            entry["bit_equal_to"] = {"case": SETUP_TWIN[name], "grad_shards": sum(same_g),
                                     "params_after_update": sum(same_p), "leaves": len(same_g)}
            if not all(same_g) or not all(same_p):
                raise AssertionError(
                    f"setup {name}: {len(same_g) - sum(same_g)} synced gradient shards and "
                    f"{len(same_p) - sum(same_p)} updated parameters differ from "
                    f"{SETUP_TWIN[name]}'s")
        del synced
    entry["step_s_median"] = statistics.median(entry["step_s"])
    entry["launches_per_step"] = want
    entry["batch_rows"] = n_rows
    if fsdp:
        entry["gathers_per_step"] = gathers
    entry["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    entry["card"] = card
    del state, setup, m
    release()
    return entry, used


def setup_step_launches(cfg, setup, B):
    """Kernel launches of one step of a train setup at batch ``B``: each batch
    row's forward, remat and backward at a rank's heads on every rank of its
    TP group that has heads (``flash_ranks``); under TP each row's TP group
    (under EP each lane's) all-reduces over model (``tp_tree_launches``);
    the sync reduces ``_synced_blocks`` blocks."""
    mesh, pcfg = setup.mesh, setup.pcfg
    n_rows = mesh.size(setup.ruleset.batch_axes(B))
    tpd = mesh.shape.get("model", 1)
    want = {k: v * n_rows * (flash_ranks(cfg, tpd) if k.startswith("flash") else tpd)
            for k, v in expected_train_launches(cfg, pcfg).items()}
    for k, v in expected_sync_launches(pcfg.grad_sync, _synced_blocks(setup)).items():
        want[k] += v
    if tpd > 1:
        want["tree_reduce"] += n_rows * tp_tree_launches(cfg, "train", tp=tpd)
    return want


def setup_oracle(dev, cfg, p0, batches, steps=SETUP_STEPS, routes=None):
    """The one-device make_train_step on the whole batch, in place on its own
    copy: the losses, grad norms and seconds of ``steps`` steps and step 1's
    gradient (from ``train_grads``; a MoE model's routings of it to
    ``routes``)."""
    ocfg = OptimConfig()
    torch.cuda.reset_peak_memory_stats()
    pcfg = ParallelConfig(remat="block", param_dtype="bfloat16")
    state = TrainState(tree_map(lambda t: t.clone(), p0), init_adam(p0, ocfg))
    with setup_route_log(routes):
        (want_g, _), grad_s = timed(lambda: train_grads(state.params, batches[0], cfg, pcfg,
                                                        _enc_fn(cfg, pcfg)))
    step = make_train_step(cfg, pcfg, ocfg)
    oracle = {"loss": [], "grad_norm": [], "step_s": [], "grad_s": grad_s}
    for batch in batches[:steps]:
        (state, m), sec = timed(lambda: step(state, batch))
        oracle["loss"].append(float(m["loss"]))
        oracle["grad_norm"].append(float(m["grad_norm"]))
        oracle["step_s"].append(sec)
    oracle["step_s_median"] = statistics.median(oracle["step_s"])
    oracle["param_bytes"] = rank_bytes([state.params], False)
    oracle["opt_bytes"] = rank_bytes([state.opt.master, state.opt.m, state.opt.v], False)
    oracle["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    # what a reference cycle would keep of the step once its references go
    # (ROADMAP.md S1): the memory only the collection frees
    del state, step, m
    dropped = torch.cuda.memory_allocated()
    release()
    oracle["held_by_cycles_bytes"] = dropped - torch.cuda.memory_allocated()
    return want_g, oracle


def greedy_flips(got, want, limit):
    """Rows whose greedy token differs between two routes' logits; each must
    be a near-tie of the reference (its top two within ``limit`` of each
    other).  Returns the number of flips."""
    a, b = got.float().argmax(-1), want.float().argmax(-1)
    flips = (a != b).nonzero().flatten().tolist()
    top2 = want.float().topk(2, dim=-1).values
    for r in flips:
        gap = float(top2[r, 0] - top2[r, 1])
        if gap > limit:
            raise AssertionError(f"a greedy token differs at row {r} where the reference's "
                                 f"top two logits are {gap:.3e} apart (limit {limit})")
    return len(flips)


def _recast(tree, dtype):
    """Every tensor of a tree of dictionaries and lists replaced, in place, by
    its cast to ``dtype``, one leaf at a time: a model the card cannot hold
    in both dtypes at once (arctic's layer: 27.8 GB of bf16, 55.6 GB of fp32)
    goes to fp32 and back (bf16 -> fp32 -> bf16 is exact).  A module function
    (see ``models.modules.tree_flatten``)."""
    for k in (list(tree) if isinstance(tree, dict) else range(len(tree))):
        if torch.is_tensor(tree[k]):
            tree[k] = tree[k].to(dtype)
        else:
            _recast(tree[k], dtype)


def _serve_routes(calls, per_step, rows, ep):
    """A setup's routings in the one-device route's order (each step's layers,
    a layer's batch rows or EP lanes one after another): over data the
    setup runs a batch row's layers before the next row's; under EP a
    layer's lanes run together."""
    if ep or rows == 1:
        return calls
    out = []
    for i in range(0, len(calls), per_step):
        step = calls[i:i + per_step]
        layers = per_step // rows
        out += [step[r * layers + l] for l in range(layers) for r in range(rows)]
    return out


def setup_serve(dev, card, arch, prompt, cache_len, new_tokens=SETUP_SERVE_TOKENS, B=8,
                mesh_spec=SETUP_SERVE_MESH, layers=None, patches=None, ep="", lengths=None):
    """(f), and under tensor parallelism (j), (k), (n), (o): ``arch`` at full
    width (``layers`` of its depth, or all), bf16, served through
    ``make_setup`` (fsdp over ``mesh_spec``, every rank stacked on the card;
    ``ep`` the EP axis, ``moe_ep_axis``): 8 requests of ``prompt`` tokens
    (whisper's against 1500 frames, llava's after ``patches`` patch
    embeddings), then ``new_tokens`` steps fed the greedy tokens of the
    one-device ``prefill`` / ``decode_step`` on the whole batch.  Over data
    alone the setup is held bit for bit against the one-device route run on
    each rank's rows (the same products: what the setup adds, the
    placement, the gathers, the rows of the state, must change no bit); under
    TP a rank's products run over its heads and vocab columns (and experts)
    and its partials are summed by the tree reduce, so each step's logits
    are held against the fp32 route as far as the one-device bf16 route is
    (SETUP_TP_FP32_MARGIN).  A MoE model's routings are held against the
    fp32 route's (``compare_setup_routes``), and its logits are compared on
    the rows whose routing agrees so far.  Against the whole batch the
    logits' elements outside tol(bf16) are counted and a greedy token may
    differ only at a near-tie (counted).  The prefill's launches asserted
    (and under TP the decode steps' tree reduces).  ``lengths`` (lo, hi):
    each request's prompt drawn in [lo, hi] tokens and left-padded with
    token 0 to ``prompt``, as the engine pads a batch.  Returns (report, the
    prefill's launches)."""
    cfg = _cut(arch, layers) if layers else get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    mesh = make_mesh(*mesh_spec, device=dev)
    ranks = mesh.size(mesh_spec[1])
    tpd = mesh.shape.get("model", 1)
    tp = tpd > 1
    params = tfm.init(0, cfg, dtype=torch.bfloat16, device=dev)
    t_init = time.perf_counter() - t_init
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (B, prompt))
    if lengths:
        for r, n in enumerate(rng.integers(lengths[0], lengths[1] + 1, B)):
            toks[r, :prompt - n] = 0
    toks = torch.from_numpy(toks).to(dev)
    batch = {"tokens": toks, **on(model_inputs(cfg, B, 2, patches), dev, torch.bfloat16)}
    pcfg = ParallelConfig(param_dtype="bfloat16", moe_ep_axis=ep)     # fsdp, the default
    pre = make_setup(cfg, ShapeConfig("prefill", "prefill", cache_len, B), mesh, pcfg)
    dec = make_setup(cfg, ShapeConfig("decode", "decode", cache_len, B), mesh, pcfg)
    b_axes = pre.ruleset.batch_axes(B) or ()
    n_rows = mesh.size(b_axes)
    # the decode caches in the flash-decoding layout: KV heads that do not
    # divide the degree, or a batch that no data axis divides
    seq = cfg.family != "ssm" and ((tp and cfg.n_kv_heads % tpd != 0) or not b_axes)
    enc_fn = _enc_fn(cfg, ParallelConfig(remat="none"))
    bf = tol(torch.bfloat16)
    routes = {"one": [], "ref": [], "got": []} if cfg.n_experts else {}

    with torch.inference_mode():
        def one_device(rows, feed=None, weights=params):
            """prefill + ``new_tokens`` decode steps of the batch's ``rows``,
            fed ``feed``'s greedy tokens (its own without)."""
            dt = tree_flatten(weights)[0][0].dtype
            logits, st = tfm.prefill(weights, {k: v[rows] if k == "tokens" else v[rows].to(dt)
                                               for k, v in batch.items()}, cfg, None,
                                     cache_len, enc_fn=enc_fn)
            out = [logits]
            for t in range(new_tokens):
                src = feed[t][rows] if feed is not None else out[t]
                logits, st = tfm.decode_step(weights, src.argmax(-1)[:, None], st, cfg, None)
                out.append(logits)
            return out
        with setup_route_log(routes.get("one")):
            want, t_one = timed(lambda: one_device(slice(None)))
        want_rows = want32 = None
        if tp:                 # the fp32 route, fed the same tokens (SETUP_TP_FP32_MARGIN)
            _recast(params, torch.float32)
            with setup_route_log(routes.get("ref")):
                want32 = [w.float() for w in one_device(slice(None), want)]
            _recast(params, torch.bfloat16)
            release()
        else:
            b = B // ranks
            per_rank = [one_device(slice(j * b, (j + 1) * b), want) for j in range(ranks)]
            want_rows = [torch.cat([r[t] for r in per_rank]) for t in range(new_tokens + 1)]
            del per_rank
        placed = pre.init_state(params)
        _zero_launches()
        with _counting_gathers() as counts, flash_heads() as heads, ssd_heads() as s_heads, \
                setup_route_log(routes.get("got")):
            (got0, state), t_pre = timed(lambda: pre.step_fn(placed, batch))
        used = _launches()
        want_l = {k: v * n_rows * (flash_ranks(cfg, tpd) if k.startswith("flash") else tpd)
                  for k, v in expected_launches(cfg).items()}
        if tp:
            want_l["tree_reduce"] += n_rows * tp_tree_launches(cfg, "prefill", tp=tpd)
        if used != want_l:
            raise AssertionError(f"setup serve {arch}: the prefill launched {used}, "
                                 f"expected {want_l}")
        got = [got0]

        def steps(st):
            for t in range(new_tokens):
                logits, st = dec.step_fn(placed, st, want[t].argmax(-1)[:, None])
                got.append(logits)
            return st
        _zero_launches()
        with setup_route_log(routes.get("got")):
            state, t_dec = timed(lambda: steps(state))
        dec_used = _launches()
        per_step = tp_tree_launches(cfg, "decode", tp=tpd, seq=seq)
        if tp and dec_used["tree_reduce"] != new_tokens * n_rows * per_step:
            raise AssertionError(f"setup serve {arch}: {new_tokens} decode steps launched "
                                 f"{dec_used}, expected {new_tokens * n_rows} x "
                                 f"{per_step} tree reduces")
    same = [torch.equal(g, w) for g, w in zip(got, want_rows)] if want_rows else []
    if want_rows and not all(same):
        t = same.index(False)
        err = float((got[t].float() - want_rows[t].float()).abs().max())
        raise AssertionError(f"setup serve {arch}: the logits of {len(same) - sum(same)} "
                             f"steps differ from the one-device route on the same rows "
                             f"(first step {t}, max abs err {err:.3e})")
    # the rows each step's logits are compared on: all, or for a MoE model
    # those whose last token chose the fp32 route's experts in every layer
    # (as the parity phase compares a row where its last token's routing
    # agrees; a flip at an earlier position reaches the logits through
    # attention only)
    rows = [torch.ones(B, dtype=torch.bool)] * len(got)
    routing = None
    if routes and tp:
        L = cfg.num_layers
        ordered = _serve_routes(routes["got"], n_rows * L, n_rows, ep)
        routing, agree = compare_setup_routes(f"setup serve {arch}", ordered, routes["one"],
                                              routes["ref"], n_rows, cfg.top_k)
        rows = [torch.stack([a[:, -1] for a in agree[t * L:(t + 1) * L]]).all(dim=0)
                for t in range(len(got))]
        if not all(r.any() for r in rows):
            raise AssertionError(f"setup serve {arch}: a step with no row whose last token's "
                                 f"routing agrees with the fp32 route's: {routing}")
        routing["rows_compared_per_step"] = [int(r.sum()) for r in rows]
    outside, errs, fro, flips = [], [], [], 0
    for g, w, r in zip(got, want, rows):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"setup serve {arch}: non-finite logits")
        err = (g - w).abs()
        errs.append(float(err.max()))
        fro.append(fro_rel(g, w))
        outside.append(outside_tol(g, w, bf))
        flips += greedy_flips(g[r.to(g.device)], w[r.to(w.device)],
                              bf["atol"] + bf["rtol"] * float(w.abs().max()))
    vs32 = None
    if tp:
        vs32 = {"tp": [fro_rel(g[r.to(g.device)], w[r.to(w.device)])
                       for g, w, r in zip(got, want32, rows)],
                "one_device_bf16": [fro_rel(g[r.to(g.device)], w[r.to(w.device)])
                                    for g, w, r in zip(want, want32, rows)]}
        vs32["limit"] = [max(bf["rtol"], SETUP_TP_FP32_MARGIN * e)
                         for e in vs32["one_device_bf16"]]
        bad = [t for t, (e, lim) in enumerate(zip(vs32["tp"], vs32["limit"])) if not e <= lim]
        if bad:
            raise AssertionError(f"setup serve {arch}: the logits of steps {bad} are further "
                                 f"from the fp32 route than allowed: {vs32}")
    report = {"config": f"{arch} full width, {cfg.num_layers} layers, bf16, fsdp over "
                        f"{dict(zip(*mesh_spec[::-1]))}" + (f", experts over {ep!r}" if ep else ""),
              "batch": B, "prompt": prompt, "cache": cache_len, "new_tokens": new_tokens,
              **({"frames": cfg.enc_seq} if cfg.family == "audio" else {}),
              **({"patches": patches} if patches else {}),
              "whole_batch": {"max_abs_err": errs, "fro_rel": fro, "outside_tol_bf16": outside,
                              "elements_per_step": got[0].numel(), "greedy_flips": flips},
              **({"fro_rel_vs_fp32": vs32} if vs32 else {}),
              **({"routing": routing} if routing else {}),
              "prefill_launches": used, "decode_launches": dec_used,
              "flash_heads": sorted(heads), "ssd_heads": sorted(s_heads),
              "prefill_gathers": dict(counts),
              "param_bytes_per_rank": rank_bytes([placed], True),
              "decode_state_bytes_per_rank": state_bytes_per_rank(state, pre.state_shardings,
                                                                  mesh),
              "flash_decoding": seq,
              **({"expert_bytes_per_rank": expert_bytes_per_rank(pre, placed)}
                 if cfg.n_experts else {}),
              "seconds": {"init": t_init, "setup": {"prefill": t_pre, "decode": t_dec},
                          "one_device": {"prefill_and_decode": t_one}},
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "card": card}
    if not tp:
        report["bit_equal_to_one_device_on_the_ranks_rows"] = sum(same)
    del params, placed, state, want, want_rows, want32, got, pre, dec
    release()
    return report, used


def setup_tp_whisper(dev, card):
    """(j) train: whisper-medium at full width and depth, fsdp over
    SETUP_TP_MESH, one step against the one-device step (B 8 x 448 tokens,
    1500 frames)."""
    arch, B, S = SETUP_TP_WHISPER[:3]
    cfg = get_config(arch)
    batches = setup_batches(cfg, B, S, steps=1)
    for b in batches:
        b.update(model_inputs(cfg, B, 3))
    p0 = tfm.init(0, cfg, dtype=torch.bfloat16, device=dev)
    want_g, oracle = setup_oracle(dev, cfg, p0, batches, steps=1)
    want32 = setup_fp32_grads(cfg, p0, batches[0])
    release()
    entry, used = setup_train_case(dev, card, cfg, p0, batches, want_g, oracle, "fsdp", "flat",
                                   *SETUP_TP_MESH, steps=1, want32=want32)
    del p0, want_g, want32
    release()
    return {"config": f"{arch} full width and depth, B {B} x {S}, {cfg.enc_seq} frames",
            "one_device": oracle, "fsdp_flat_tp2": entry}, used


def setup_moe_train(dev, card):
    """(l), (m): mixtral-8x7b at full width and SETUP_MOE_TRAIN's depth,
    bf16, trained through ``make_train_setup`` over SETUP_MOE_MESH under TP +
    fsdp and under EP + TP (SETUP_MOE_TRAIN_CASES), against one one-device
    oracle on the same weights and batches: the loss of each step, step 1's
    synced gradient against the fp32 route as far as the one-device bf16
    route is, step 1's routing against the fp32 route's.  The oracle's state
    is released before a setup builds (the card holds 1.7e9 parameters'
    weights, fp32 master and moments, ~24 GB, once at a time); its gradients
    and routings are kept."""
    arch, layers, B, S = SETUP_MOE_TRAIN
    cfg = _cut(arch, layers)
    batches = setup_batches(cfg, B, S, steps=max(c[2] for c in SETUP_MOE_TRAIN_CASES))
    t0 = time.perf_counter()
    p0 = tfm.init(0, cfg, dtype=torch.bfloat16, device=dev)
    init_s = time.perf_counter() - t0
    routes = {"one": [], "ref": []}
    want_g, oracle = setup_oracle(dev, cfg, p0, batches, steps=len(batches),
                                  routes=routes["one"])
    want32 = setup_fp32_grads(cfg, p0, batches[0], routes=routes["ref"])
    release()
    report = {"config": f"{arch} full width, {layers} of {get_config(arch).num_layers} layers, "
                        f"bf16 params, fp32 master and moments, block remat",
              "batch": B, "seq": S, "init_s": init_s, "one_device": oracle, "card": card}
    launches = {}
    for sharding, ep, steps in SETUP_MOE_TRAIN_CASES:
        name = setup_case_name(sharding, "flat", dict(zip(SETUP_MOE_MESH[1],
                                                          SETUP_MOE_MESH[0])))
        name += f"_ep_{ep}" if ep else ""
        report[name], launches[f"moe_{name}"] = setup_train_case(
            dev, card, cfg, p0, batches, want_g, oracle, sharding, "flat", *SETUP_MOE_MESH,
            steps=steps, want32=want32, ep=ep, routes=routes)
    del p0, want_g, want32
    release()
    return report, launches


def setup_ssm(dev, card):
    """(p)-(s): the SSM and hybrid families under tensor parallelism
    (SETUP_SSM_TRAIN, SETUP_SSM_SERVE), each train case against its own
    one-device oracle (the losses; step 1's synced gradient against the fp32
    route as far as the one-device bf16 route is), each served one through
    ``setup_serve``; every SSD scan and flash call of the setup at a rank's
    heads (asserted).  Returns (report, launches)."""
    report, launches = {"phase": "setup_ssm", "card": card}, {}
    B, S = SETUP_BATCH
    for arch, layers, sharding, (mshape, axes), steps in SETUP_SSM_TRAIN:
        cfg = _cut(arch, layers)
        tp = dict(zip(axes, mshape))["model"]
        batches = setup_batches(cfg, B, S, steps=steps)
        p0 = tfm.init(0, cfg, dtype=torch.bfloat16, device=dev)
        want_g, oracle = setup_oracle(dev, cfg, p0, batches, steps=steps)
        want32 = setup_fp32_grads(cfg, p0, batches[0])
        release()
        entry, used = setup_train_case(dev, card, cfg, p0, batches, want_g, oracle, sharding,
                                       "flat", mshape, axes, steps=steps, want32=want32)
        want_heads = {"ssd": [cfg.ssm_heads // tp],
                      "flash": [(cfg.n_heads // tp, cfg.n_kv_heads // tp)] if cfg.n_heads
                      else []}
        if entry["ssd_heads"] != want_heads["ssd"] or entry["flash_heads"] != want_heads["flash"]:
            raise AssertionError(f"setup {cfg.name}: SSD heads {entry['ssd_heads']}, flash "
                                 f"heads {entry['flash_heads']}, expected {want_heads}")
        entry["ssd_bwd_heads_per_block"] = bwd_heads_per_block(cfg.ssm_heads // tp,
                                                               cfg.ssm_groups)
        name = setup_case_name(sharding, "flat", dict(zip(axes, mshape)))
        report[f"{arch}_{name}"] = {
            "config": f"{arch} full width, {layers} of {get_config(arch).num_layers} layers, "
                      f"bf16 params, fp32 master and moments, block remat, B {B} x S {S}",
            "one_device": oracle, name: entry}
        launches[f"ssm_{arch}_{name}"] = used
        del p0, want_g, want32, batches
        release()
    for arch, layers, prompt, cache_len in SETUP_SSM_SERVE:
        name = f"serve_{arch}_tp2"
        report[name], launches[name] = setup_serve(dev, card, arch, prompt, cache_len,
                                                   mesh_spec=SETUP_TP_MESH, layers=layers)
        cfg = _cut(arch, layers)
        want_heads = ([cfg.ssm_heads // 2],
                      [[cfg.n_heads // 2, cfg.n_kv_heads // 2]] if cfg.n_heads else [])
        got_heads = (report[name]["ssd_heads"], [list(h) for h in report[name]["flash_heads"]])
        if got_heads != want_heads:
            raise AssertionError(f"setup serve {arch}: SSD / flash heads {got_heads}, "
                                 f"expected {want_heads}")
    return report, launches


def setup_heads(dev, card):
    """(t)-(w): heads that do not divide the TP degree and the flash-decoding
    layout (SETUP_HEADS_TRAIN, SETUP_HEADS_SERVE): the train case against
    its one-device oracle (the loss; step 1's synced gradient against the
    fp32 route as far as the one-device bf16 route is), each served one
    through ``setup_serve``; every flash call at a rank's padded heads
    (asserted), the decode steps' combine counted in their tree reduces.
    Returns (report, launches)."""
    report, launches = {"phase": "setup_heads", "card": card}, {}
    B, S = SETUP_BATCH
    arch, layers, sharding, (mshape, axes), steps = SETUP_HEADS_TRAIN
    cfg = _cut(arch, layers)
    tpd = dict(zip(axes, mshape))["model"]
    batches = setup_batches(cfg, B, S, steps=steps)
    p0 = tfm.init(0, cfg, dtype=torch.bfloat16, device=dev)
    want_g, oracle = setup_oracle(dev, cfg, p0, batches, steps=steps)
    want32 = setup_fp32_grads(cfg, p0, batches[0])
    release()
    entry, used = setup_train_case(dev, card, cfg, p0, batches, want_g, oracle, sharding,
                                   "flat", mshape, axes, steps=steps, want32=want32)
    hp = -(-cfg.n_heads // tpd)
    want_heads = sorted({(hp, hp), (cfg.n_heads - hp * (flash_ranks(cfg, tpd) - 1),) * 2})
    if entry["flash_heads"] != want_heads:
        raise AssertionError(f"setup {cfg.name}: flash heads {entry['flash_heads']}, "
                             f"expected {want_heads}")
    name = setup_case_name(sharding, "flat", dict(zip(axes, mshape)))
    report[f"{arch}_{name}"] = {
        "config": f"{arch} full width, {layers} of {get_config(arch).num_layers} layers, "
                  f"bf16 params, fp32 master and moments, block remat, B {B} x S {S}",
        "one_device": oracle, name: entry}
    launches[f"heads_{arch}_{name}"] = used
    del p0, want_g, want32, batches
    release()
    for arch, layers, prompt, cache_len, b, mesh_spec, new, lengths in SETUP_HEADS_SERVE:
        name = f"serve_heads_{arch}_" + "x".join(map(str, mesh_spec[0])) + f"_b{b}"
        report[name], launches[name] = setup_serve(
            dev, card, arch, prompt, cache_len, new_tokens=new, B=b, mesh_spec=mesh_spec,
            layers=layers, lengths=lengths)
        cfg = _cut(arch, layers) if layers else get_config(arch)
        tpd = dict(zip(mesh_spec[1], mesh_spec[0]))["model"]
        hp = -(-cfg.n_heads // tpd)
        got = {tuple(h) for h in report[name]["flash_heads"]}
        if {q for q, _ in got} - {hp, cfg.n_heads - hp * (flash_ranks(cfg, tpd) - 1)}:
            raise AssertionError(f"setup serve {arch}: flash heads {sorted(got)}, a rank's "
                                 f"padded heads are {hp}")
        if not report[name]["flash_decoding"]:
            raise AssertionError(f"setup serve {arch}: the caches are not in the "
                                 f"flash-decoding layout")
    return report, launches


def _stored_leaves(d):
    """(manifest, each stored leaf as a tensor) of a checkpoint directory,
    read one leaf at a time."""
    manifest = json.loads((d / "MANIFEST.json").read_text())
    for meta in manifest["leaves"]:
        t = torch.from_numpy(np.load(d / meta["file"]))
        yield meta, (t.view(torch.int16).view(torch.bfloat16) if meta["dtype"] == "bfloat16"
                     else t)


def _manifest_sans_crc(d):
    m = json.loads((d / "MANIFEST.json").read_text())
    for leaf in m["leaves"]:
        leaf.pop("crc32")
    return m


def setup_trainer(dev, card):
    """(x) ``Trainer(mesh=)``, its checkpoint of the sharded state and the
    elastic resume (SETUP_TRAINER) against the one-device ``Trainer`` on the
    same seed and batches: the losses of steps 1-3 (SETUP_LOSS_RTOL); every
    leaf of the mesh's checkpoint against the one-device one's, the bf16
    parameters to tol(bf16), each fp32 master and moment leaf against the
    fp32 route's step 2 as far as the one-device bf16 route's same leaf is
    (SETUP_TP_FP32_MARGIN, or SETUP_GRAD_FRO where that is larger: the
    setup phase's rule for synced gradients, leaf by leaf); the step-3 parameters of the
    run resumed on the survivors and of the one-device run resumed from the
    mesh's checkpoint within tol(bf16) of the reference's.  The launches of
    every step (asserted), save and resume seconds, the resume's peak memory
    (asserted under the placed state's bytes plus twice its largest leaf),
    the snapshot's host bytes, whether the torn save's debris was swept.
    Returns (report, launches)."""
    arch, B, S, (mshape, axes) = SETUP_TRAINER
    cfg = get_config(arch)
    shape = ShapeConfig(f"train_{B}x{S}", "train", S, B)
    ocfg = OptimConfig()
    pcfg = ParallelConfig(remat="block", param_dtype="bfloat16", param_sharding="fsdp",
                          grad_sync="flat")
    report = {"phase": "setup_trainer", "card": card,
              "config": f"{arch} full width and depth, bf16 params, fp32 master and moments, "
                        f"block remat, SyntheticLM B {B} x S {S}, fsdp over "
                        + " x ".join(f"{a} {n}" for a, n in zip(axes, mshape))}
    launches = {}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_trainer_", dir=root)
    ref_dir, mesh_dir = os.path.join(ckpt_root, "one_device"), os.path.join(ckpt_root, "mesh")

    def trainer(steps, d, mesh=None):
        tcfg = TrainerConfig(steps=steps, log_every=1, checkpoint_every=2, checkpoint_dir=d)
        return Trainer(cfg, shape, pcfg, ocfg, tcfg,
                       **({"mesh": mesh} if mesh is not None else {"device": dev}))

    def counted(tr, want, name):
        """Wrap ``tr.step_fn``: each step's launches against ``want``."""
        step_fn, used = tr.step_fn, launches.setdefault(name, {k: 0 for k in WRAPPERS})

        def step(state, batch):
            _zero_launches()                      # counts of this path only
            out = step_fn(state, batch)
            got = _launches()
            if got != want:
                raise AssertionError(f"setup_trainer {name}: launched {got}, expected {want}")
            for k in used:
                used[k] += got[k]
            return out
        tr.step_fn = step

    def step3(tr, state, name, hold=True):
        """Step 3 (batch index 2 of the Trainer's data) through ``tr.step_fn``,
        its loss held against the reference's."""
        t0 = time.perf_counter()
        state, m = tr.step_fn(state, tr.data.batch(2))
        loss = float(m["loss"])
        report[name + "_step3"] = {"loss": loss, "step_s": time.perf_counter() - t0}
        if hold and not abs(loss - ref_losses[2]) <= SETUP_LOSS_RTOL * abs(ref_losses[2]):
            raise AssertionError(f"setup_trainer {name}: step 3 loss {loss} against the "
                                 f"one-device {ref_losses[2]}")
        return state

    def hold_params(name, params):
        """Logical parameter leaves (an iterable, in the tree's order) against
        the reference's step 3, tol(bf16)."""
        bad = sum(outside_tol(got, want.to(dev), tol(torch.bfloat16))
                  for got, want in zip(params, ref_params))
        report[name + "_step3"]["params_outside_tol_bf16"] = bad
        if bad:
            raise AssertionError(f"setup_trainer {name}: {bad} step-3 parameters outside "
                                 f"tol(bf16) of the one-device run's")

    try:
        one = trainer(2, ref_dir)
        # the fp32 route's step 2 on the bf16 draw: the reference of the fp32 leaves
        p32 = tree_map(lambda t: t.float(), tfm.init(0, cfg, dtype=torch.bfloat16, device=dev))
        state = TrainState(p32, init_adam(p32, ocfg))
        step32 = make_train_step(cfg, ParallelConfig(remat="block", param_dtype="float32",
                                                     compute_dtype="float32"), ocfg)
        for i in range(2):
            state, _ = step32(state, one.data.batch(i))
        ref32 = [t.cpu() for t in _flat(state.opt) if t.dtype == torch.float32]
        del state, p32, step32
        release()

        # the one-device reference: steps 1-2 by run() (its checkpoint at 2), step 3
        counted(one, expected_train_launches(cfg, pcfg), "x_one_device")
        t0 = time.perf_counter()
        state = one.run()
        run_s = time.perf_counter() - t0
        ref_losses = [h["loss"] for h in one.history]
        report["one_device"] = {"step_s": [h["seconds"] for h in one.history],
                                "save_s": run_s - sum(h["seconds"] for h in one.history)}
        state = step3(one, state, "one_device", hold=False)
        ref_losses.append(report["one_device_step3"]["loss"])
        report["one_device"]["loss"] = ref_losses
        ref_params = [t.cpu() for t in _flat(state.params)]
        del state, one
        release()

        # the Trainer over the mesh: steps 1-2, its async checkpoint at 2
        mesh = make_mesh(mshape, axes, device=dev)
        tr = trainer(2, mesh_dir, mesh)
        counted(tr, setup_step_launches(cfg, tr.setup, B), "x_trainer_mesh")
        state = tr.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = tr.run(state)
        run_s = time.perf_counter() - t0
        losses = [h["loss"] for h in tr.history]
        for i, (got, want) in enumerate(zip(losses, ref_losses)):
            if not abs(got - want) <= SETUP_LOSS_RTOL * abs(want):
                raise AssertionError(f"setup_trainer mesh: step {i + 1} loss {got} against "
                                     f"the one-device {want}")
        logical_shapes = _flat(tr.setup.state_shapes)
        snapshot_bytes = sum(t.numel() * t.element_size() for t in logical_shapes)
        report["mesh"] = {"loss": losses, "step_s": [h["seconds"] for h in tr.history],
                          "save_s": run_s - sum(h["seconds"] for h in tr.history),
                          "snapshot_host_bytes": snapshot_bytes,
                          "state_bytes_on_card": sum(nbytes(t) for t in _flat(state)),
                          "launches_per_step": setup_step_launches(cfg, tr.setup, B)}

        # every leaf of the mesh's checkpoint against the one-device one's
        got_dir, want_dir = Path(mesh_dir) / "step_00000002", Path(ref_dir) / "step_00000002"
        if _manifest_sans_crc(got_dir) != _manifest_sans_crc(want_dir):
            raise AssertionError("setup_trainer: the mesh's manifest is not the one-device one's")
        # fp32 leaves, each against the fp32 route: (file, mesh's distance,
        # one-device's distance, the limit); and the mesh's against the
        # one-device run's (reported)
        outside, fp32_dist, fp32_leaves, direct = 0, [], iter(ref32), 0.0
        for (meta, got), (_, want) in zip(_stored_leaves(got_dir), _stored_leaves(want_dir)):
            got, want = got.to(dev), want.to(dev)
            if meta["dtype"] == "bfloat16":
                outside += outside_tol(got, want, tol(torch.bfloat16))
            elif meta["dtype"] == "float32":
                w32 = next(fp32_leaves).to(dev)
                one32 = fro_rel(want, w32)
                direct = max(direct, fro_rel(got, want))
                fp32_dist.append((meta["file"], fro_rel(got, w32), one32,
                                  max(SETUP_GRAD_FRO, SETUP_TP_FP32_MARGIN * one32)))
            elif not torch.equal(got, want):
                raise AssertionError(f"setup_trainer: {meta['file']} differs")
        worst = max(fp32_dist, key=lambda d: d[1] / d[3])
        report["checkpoint"] = {
            "leaves": len(logical_shapes), "bf16_outside_tol": outside,
            "fp32_leaves": len(fp32_dist),
            "fp32_fro_rel_vs_fp32_route": {
                "mesh_worst": max(d[1] for d in fp32_dist),
                "one_device_worst": max(d[2] for d in fp32_dist),
                "mesh_over_0.02": sum(d[1] > SETUP_GRAD_FRO for d in fp32_dist),
                "one_device_over_0.02": sum(d[2] > SETUP_GRAD_FRO for d in fp32_dist),
                "mesh_vs_one_device_worst": direct,
                "closest_to_its_limit": dict(zip(("file", "mesh", "one_device", "limit"),
                                                 worst))}}
        if outside or worst[1] > worst[3]:
            raise AssertionError(f"setup_trainer: the mesh's checkpoint leaves {outside} bf16 "
                                 f"elements outside tol(bf16); fp32 leaf {worst[0]} is "
                                 f"{worst[1]:.3e} from the fp32 route (the one-device "
                                 f"{worst[2]:.3e}, limit {worst[3]:.3e})")
        del ref32
        shutil.rmtree(ref_dir)                  # at most two checkpoints on the disk

        # a torn save of step 3, one rank of four dead, step 2 restored on the survivors
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = faults.crash_and_recover(mesh_dir, cfg, shape, mesh, state, torn_step=3,
                                       n_failed=1, seed=0, pcfg=pcfg, ocfg=ocfg)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - start
        placed = [nbytes(t) for t in _flat(rec.state)]
        swept = not os.path.exists(os.path.join(mesh_dir, "step_00000003.tmp"))
        report["recovered"] = {"plan": rec.plan, "failed": list(rec.failed),
                               "ranks": list(rec.mesh.ranks), "resumed_step": rec.resumed_step,
                               "resume_s": resume_s, "debris_swept": swept,
                               "resume_peak_bytes_over_start": peak,
                               "placed_state_bytes": sum(placed),
                               "largest_leaf_bytes": max(placed)}
        if rec.plan != {"data": 1, "model": 2} or rec.resumed_step != 2 or not swept:
            raise AssertionError(f"setup_trainer: recovered {report['recovered']}")
        if peak > sum(placed) + 2 * max(placed):
            raise AssertionError(f"setup_trainer: the resume's peak {peak} passes the placed "
                                 f"state {sum(placed)} and twice its largest leaf")
        del state, tr
        release()
        survivors = trainer(3, mesh_dir, rec.mesh)
        counted(survivors, setup_step_launches(cfg, rec.setup, B), "x_survivors")
        state = step3(survivors, rec.state, "survivors")
        hold_params("survivors", (rec.setup.leaf_to_logical(i, t)     # the parameters lead
                                  for i, t in enumerate(_flat(state.params))))
        del state, rec, survivors
        release()

        # the one-device Trainer resumes the mesh's checkpoint
        again = trainer(3, mesh_dir)
        counted(again, expected_train_launches(cfg, pcfg), "x_one_device_resumed")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = again.resume_or_init()
        torch.cuda.synchronize()
        report["one_device_resumed"] = {"resume_s": time.perf_counter() - t0, "step": again.step,
                                        "max_memory_allocated_bytes":
                                            torch.cuda.max_memory_allocated()}
        if again.step != 2:
            raise AssertionError(f"setup_trainer: the one-device Trainer resumed at {again.step}")
        state = step3(again, state, "one_device_resumed")
        hold_params("one_device_resumed", _flat(state.params))
        del state, again
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    release()
    report["launches"] = launches
    return report, launches


def phase_setup(dev, card):
    """llama3.2-1b at full width and depth through ``make_train_setup`` (the
    four SETUP_CASES) against the one-device ``make_train_step``: the loss of
    each step, each synced gradient leaf of step 1 against the one-device
    gradient, the launches of every step (asserted), zero1's AdamW update
    bit-equal to the replicated one on the same synced gradient, and the
    fsdp cases' synced gradient shards and updates bit-equal to their twins'
    (SETUP_TWIN); then (g)-(i), the same under tensor parallelism over
    ``model`` (SETUP_TP_CASES, (h) bit for bit against (g)); (e) mamba2
    under fsdp; (f) the serving setups; (j) whisper-medium trained and served
    under TP; (k) llama3.2-1b and llava-next-34b served over model 4; (l)-(o)
    the MoE family under TP and EP (``setup_moe_train``, SETUP_MOE_SERVE), on
    a line of their own; (p)-(s) the SSM and hybrid families under TP
    (``setup_ssm``), on a line of their own; (t)-(w) heads that do not
    divide the TP degree and the flash-decoding layout (``setup_heads``), on
    a line of their own; (x) ``Trainer(mesh=)``, its checkpoint and the
    elastic resume (``setup_trainer``), on a line of its own.  Returns each
    case's launches."""
    cfg = get_config(SETUP_ARCH)
    B, S = SETUP_BATCH
    batches = setup_batches(cfg, B, S)
    p0 = tfm.init(0, cfg, dtype=torch.bfloat16, device=dev)
    report = {"phase": "setup", "config": f"{SETUP_ARCH} full width and depth, bf16 params, "
                                          f"fp32 master and moments, block remat",
              "batch": B, "seq": S, "steps": SETUP_STEPS, "card": card}
    want_g, report["one_device"] = setup_oracle(dev, cfg, p0, batches)

    launches, kept = {}, {}
    for n, (sharding, mode, mshape, axes) in enumerate(SETUP_CASES):
        name = f"{sharding}_{mode}"
        if n == 1:
            # zero1's update and the replicated one on case (a)'s synced
            # gradient, from the same state: bit for bit
            mesh = make_mesh(mshape, axes, device=dev)
            r = make_train_setup(cfg, ShapeConfig("t", "train", S, B), mesh, ParallelConfig(
                remat="block", param_dtype="bfloat16", param_sharding=sharding,
                grad_sync=mode))
            st = r.init_state(tree_map(lambda t: t.clone(), p0))
            st, _ = r.update_fn(st, kept["zero1_flat"]["grads"])
            z = kept["zero1_flat"]
            same = [torch.equal(a, b) for a, b in zip(_flat(st.params), _flat(z["params"]))]
            same_master = [torch.equal(unshard_leaf(rows, spec, z["mesh"]), full)
                           for rows, full, spec in zip(_flat(z["master"]),
                                                       _flat(st.opt.master), z["specs"])]
            report["update_bit_equal"] = {"params": sum(same), "master": sum(same_master),
                                          "leaves": len(same)}
            if not all(same) or not all(same_master):
                raise AssertionError(f"setup: zero1's update differs from the replicated one "
                                     f"in {len(same) - sum(same)} parameter and "
                                     f"{len(same_master) - sum(same_master)} master leaves")
            del st, r, z["master"], z      # z, a name for kept's entry, would hold its
            release()                       # gradient and parameters to the phase's end
        report[name], launches[name] = setup_train_case(
            dev, card, cfg, p0, batches, want_g, report["one_device"], sharding, mode,
            mshape, axes, kept)
    for k in list(kept):
        del kept[k]
    release()
    # (g)-(i) tensor parallelism over model
    want32 = setup_fp32_grads(cfg, p0, batches[0])
    release()
    for sharding, mode, mshape, axes, steps in SETUP_TP_CASES:
        name = setup_case_name(sharding, mode, dict(zip(axes, mshape)))
        report[name], launches[name] = setup_train_case(
            dev, card, cfg, p0, batches, want_g, report["one_device"], sharding, mode,
            mshape, axes, kept, steps=steps, want32=want32)
    del kept, want_g, want32
    release()
    # (e) the SSD kernels through gathered Mamba2 blocks
    ssm = _cut(SETUP_SSM_ARCH, SETUP_SSM_LAYERS)
    ssm_batches = setup_batches(ssm, B, S, steps=1)
    p_ssm = tfm.init(0, ssm, dtype=torch.bfloat16, device=dev)
    want_ssm, oracle_ssm = setup_oracle(dev, ssm, p_ssm, ssm_batches, steps=1)
    report["ssm"] = {"config": f"{SETUP_SSM_ARCH} full width, {SETUP_SSM_LAYERS} of "
                               f"{get_config(SETUP_SSM_ARCH).num_layers} layers",
                     "one_device": oracle_ssm}
    report["ssm"]["fsdp_flat"], launches["ssm_fsdp_flat"] = setup_train_case(
        dev, card, ssm, p_ssm, ssm_batches, want_ssm, oracle_ssm, "fsdp", "flat", (4,),
        ("data",), steps=1)
    del p_ssm, want_ssm
    release()
    # (f) the serving setups
    for arch, prompt, cache_len in SETUP_SERVE:
        report[f"serve_{arch}"], launches[f"serve_{arch}"] = setup_serve(
            dev, card, arch, prompt, cache_len)
    # (j) whisper-medium under TP: one train step, then served
    report["tp_whisper"], launches["tp_whisper_train"] = setup_tp_whisper(dev, card)
    arch, _, _, prompt, cache_len = SETUP_TP_WHISPER
    report["tp_whisper"]["serve"], launches["tp_whisper_serve"] = setup_serve(
        dev, card, arch, prompt, cache_len, mesh_spec=SETUP_TP_MESH)
    # (k) served over model 4
    for arch, layers, prompt, cache_len, patches in SETUP_TP4_SERVE:
        report[f"serve_tp4_{arch}"], launches[f"serve_tp4_{arch}"] = setup_serve(
            dev, card, arch, prompt, cache_len, mesh_spec=SETUP_TP4_MESH, layers=layers,
            patches=patches)
    emit(report)
    del p0, report
    release()
    # (l)-(o) the MoE family under TP and EP, on a line of their own
    moe_report = {"phase": "setup_moe", "card": card}
    moe_report["train"], used = setup_moe_train(dev, card)
    launches.update(used)
    for arch, layers, prompt, cache_len, mesh_spec, ep in SETUP_MOE_SERVE:
        name = f"serve_moe_{arch}" + (f"_ep_{ep}" if ep else "")
        moe_report[name], launches[name] = setup_serve(
            dev, card, arch, prompt, cache_len, new_tokens=SETUP_MOE_TOKENS,
            mesh_spec=mesh_spec, layers=layers, ep=ep)
    emit(moe_report)
    del moe_report
    release()
    ssm_report, used = setup_ssm(dev, card)
    launches.update(used)
    emit(ssm_report)
    del ssm_report
    release()
    # (t)-(w) heads that do not divide the degree, on a line of their own
    heads_report, used = setup_heads(dev, card)
    launches.update(used)
    emit(heads_report)
    del heads_report
    release()
    # (x) Trainer(mesh=), checkpoints of sharded state, the elastic resume
    trainer_report, used = setup_trainer(dev, card)
    launches.update(used)
    emit(trainer_report)
    return launches


# the stream phase: weight streaming (train/streaming.py) at full width, bf16
# parameters, B 4 x S 2048 of SyntheticLM (its step-0 batch in every step),
# the reference's plain SGD on the host at its default lr, 1e-3 (at 3e-3 and
# above llama3.2-1b's and mixtral's losses rose again by the third step).  (a)
# llama3.2-1b and (b) mamba2-1.3b at full depth and (c) mixtral-8x7b at 1
# layer against the monolithic loss_fn gradient with block remat, then
# STREAM_STEPS steps; (c) mixtral at as many of its 32 layers as host memory
# holds with STREAM_HOST_MARGIN to spare, and (d) arctic-480b at 2 of 35
# layers, STREAM_DEEP_STEPS steps each, every layer drawn on the card one at
# a time (init of a one-layer configuration, layer l from the seed (0, l)).
# The host update sets a deep case's pace, and the card machine's host ran it
# at 0.7-1.2e9 elements/s in different runs: a deep case also takes no more
# layers than its steps can update in STREAM_DEEP_BUDGET_S at the rate (a)-(c)
# measured (STREAM_DEEP_MIN_LAYERS at least: arctic's one-slot ring swaps a
# slot only past one layer), so that the script stays inside its time limit
# on a slow host; 30 s since the launch phase came (90 s before)
STREAM_BATCH = (4, 2048)
STREAM_LR = 1e-3
STREAM_STEPS = 3
STREAM_DEEP_STEPS = 2
STREAM_HOST_MARGIN = 16 << 30
STREAM_COMPARE = [("llama3.2-1b", None), ("mamba2-1.3b", None), ("mixtral-8x7b", 1)]
STREAM_DEEP = [("mixtral-8x7b", None), ("arctic-480b", 2)]
STREAM_DEEP_BUDGET_S = 30
STREAM_DEEP_MIN_LAYERS = 2
STREAM_MEMORY_WAIT_S = 90     # pinned pages return to MemAvailable some seconds after unpinning


def host_status():
    """This process's VmRSS, VmLck and VmPin and the host's MemAvailable,
    in bytes."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key in ("VmRSS", "VmLck", "VmPin"):
                out[key] = int(value.split()[0]) * 1024
    out["MemAvailable"] = streaming.mem_available_bytes()
    return out


def stream_batch(cfg):
    B, S = STREAM_BATCH
    b = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)).batch(0)
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def stream_link(dev):
    """The link once: a 1 GiB copy each way between pinned host memory and
    the card, 5 times each (the fastest is the rate); and what
    ``pin_memory=True`` holds for 1 GiB + 4 KiB (the caching host
    allocator's rounding), given back after."""
    host = streaming._Pinned(1 << 30)
    out = {}
    try:
        d = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
        for way in ("h2d", "d2h"):
            ms = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                if way == "h2d":
                    d.copy_(host.tensor, non_blocking=True)
                else:
                    host.tensor.copy_(d, non_blocking=True)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            out[f"{way}_ms"] = ms
            out[f"{way}_GBps"] = (1 << 30) / (min(ms) / 1e3) / 1e9
        del d
        asked = (1 << 30) + 4096
        before = torch.cuda.host_memory_stats().get("allocated_bytes.current", 0)
        p = torch.empty(asked, dtype=torch.uint8, pin_memory=True)
        held = torch.cuda.host_memory_stats().get("allocated_bytes.current", 0) - before
        del p
        torch._C._host_emptyCache()
        out.update(pin_memory_asked_bytes=asked, pin_memory_held_bytes=held)
    finally:
        host.close()
    return out


def wait_for_host_memory(want):
    """Wait (at most STREAM_MEMORY_WAIT_S) until MemAvailable reaches
    ``want``: unpinned pages come back to it some seconds late.  Returns the
    seconds waited and MemAvailable."""
    gc.collect()
    torch._C._host_emptyCache()
    t0 = time.perf_counter()
    while streaming.mem_available_bytes() < want and \
            time.perf_counter() - t0 < STREAM_MEMORY_WAIT_S:
        time.sleep(1.0)
    return time.perf_counter() - t0, streaming.mem_available_bytes()


def stream_reckoned(hp, cfg):
    """Device bytes the stream should hold at its peak, a block's working
    set aside: the ring's slots, one layer's gradient, the top and its
    gradient, and the L+1 boundary activations."""
    B, S = STREAM_BATCH
    layer, top = hp._layout.nbytes, hp._top_layout.nbytes
    acts = (hp.n_layers + 1) * B * S * cfg.d_model * 2
    return {"slots": len(hp._slots) * layer, "gradient": layer, "top_and_gradient": 2 * top,
            "activations": acts,
            "total": (len(hp._slots) + 1) * layer + 2 * top + acts}


def stream_steps(dev, hp, cfg, batch, steps, link):
    """``steps`` stream_train_steps on one batch: each step's launches
    (asserted against a block-remat step's), loss, aux, the stream's
    counters, peak device memory beside the reckoned figure, and which of the
    link, the device and the host update sets the pace."""
    want = expected_train_launches(cfg, ParallelConfig(remat="block"))
    elements = sum(hp._layout.sizes.values()) * hp.n_layers + sum(hp._top_layout.sizes.values())
    out, launches = [], {name: 0 for name in WRAPPERS}
    for _ in range(steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        loss = stream_train_step(hp, batch, cfg, ParallelConfig(), lr=STREAM_LR)
        used = _launches()
        if used != want:
            raise AssertionError(f"stream {cfg.name}: a step launched {used}, expected {want}")
        for k in launches:
            launches[k] += used[k]
        s = dict(hp.stats)
        floor = s["h2d_bytes"] / (link["h2d_GBps"] * 1e9)
        paces = {"link (H2D floor)": floor, "device": s["device_s"], "host update": s["update_s"]}
        out.append({**s, "loss": loss, "launches": used, "update_elements": elements,
                    "update_elements_per_s": elements / s["update_s"],
                    "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                    "h2d_GBps": s["h2d_bytes"] / s["h2d_s"] / 1e9 if s["h2d_s"] else None,
                    "d2h_GBps": s["d2h_bytes"] / s["d2h_s"] / 1e9 if s["d2h_s"] else None,
                    "h2d_floor_s": floor, "pace": max(paces, key=paces.get)})
    losses = [o["loss"] for o in out]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"stream {cfg.name}: losses {losses}")
    if cfg.n_experts and not all(o["aux_loss"] > 0 for o in out):
        raise AssertionError(f"stream {cfg.name}: aux losses {[o['aux_loss'] for o in out]}")
    return out, launches


def stream_compare(dev, card, arch, layers, link):
    """(a)-(c): ``arch`` (at ``layers`` layers if given) streamed against the
    port's monolithic ``loss_fn`` gradient with block remat on the card: the
    total and every leaf, bit-equal or within tol(bf16) (each leaf that is
    not bit-equal named); then STREAM_STEPS steps, the losses falling."""
    cfg = _cut(arch, layers)
    batch = stream_batch(cfg)
    params = tfm.init(0, cfg, dtype=torch.bfloat16, device=dev)
    leaves, spec = tree_flatten(params)
    live = [t.requires_grad_() for t in leaves]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total, metrics = tfm.loss_fn(tree_unflatten(spec, live),
                                 {k: v.to(dev) for k, v in batch.items()}, cfg,
                                 ParallelConfig(remat="block"))
    ref = [g.detach() for g in torch.autograd.grad(total, live)]
    torch.cuda.synchronize()
    mono_s = time.perf_counter() - t0
    ref_total, ref_aux = float(total.detach()), float(metrics["aux_loss"])
    total = metrics = live = None
    for t in leaves:
        t.requires_grad_(False)
    before = host_status()
    t0 = time.perf_counter()
    hp = HostParams(params, cfg.num_layers, device=dev)
    pin_s = time.perf_counter() - t0
    held = host_status()
    params = leaves = None
    release()
    try:
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        got_total, g_top, g_layers = stream_grads(hp, batch, cfg, ParallelConfig())
        used = _launches()
        grads_stats = dict(hp.stats)
        want = expected_train_launches(cfg, ParallelConfig(remat="block"))
        if used != want:
            raise AssertionError(f"stream {arch}: stream_grads launched {used}, expected {want}")
        got = tree_flatten({**g_top, "blocks": g_layers})[0]
        paths = list(_paths({**g_top, "blocks": g_layers}))
        not_equal, worst = [], 0.0
        for path, a, b in zip(paths, got, ref):
            a = a.to(dev)
            if torch.equal(a, b):
                continue
            name = ".".join(str(p) for p in path)
            worst = max(worst, check_close(f"stream {arch} gradient {name}", a, b,
                                           **tol(torch.bfloat16)))
            not_equal.append(name)
        got_total = float(got_total)
        if not (got_total == ref_total or abs(got_total - ref_total) <= 1e-6 * abs(ref_total)):
            raise AssertionError(f"stream {arch}: total {got_total}, loss_fn {ref_total}")
        ref = g_top = g_layers = None
        # the card's update, applied as each gradient landed, against the
        # reference's update of stream_grads' gradient after the fact
        w0 = [t.clone() for t in tree_flatten(hp.host)[0]]
        steps, launches = stream_steps(dev, hp, cfg, batch, 1, link)
        update, update_not_equal = streaming.sgd_update(STREAM_LR), []
        for path, w, g, now in zip(paths, w0, got, tree_flatten(hp.host)[0]):
            update(w, g.clone())
            if not torch.equal(w, now):
                name = ".".join(str(p) for p in path)
                check_close(f"stream {arch} updated {name}", now, w, **tol(torch.bfloat16))
                update_not_equal.append(name)
        w0 = got = None
        more, more_launches = stream_steps(dev, hp, cfg, batch, STREAM_STEPS - 1, link)
        steps += more
        launches = {k: launches[k] + more_launches[k] for k in launches}
        losses = [s["loss"] for s in steps]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"stream {arch}: losses {losses} do not fall")
        return {"config": f"{cfg.name} full width, {cfg.num_layers} of "
                          f"{get_config(arch).num_layers} layers, bf16, B {STREAM_BATCH[0]} x "
                          f"S {STREAM_BATCH[1]} of SyntheticLM, lr {STREAM_LR}",
                "monolithic_total": ref_total, "monolithic_aux": ref_aux,
                "monolithic_grad_s": mono_s, "streamed_total": got_total,
                "streamed_aux": grads_stats["aux_loss"], "leaves": len(paths),
                "leaves_not_bit_equal": not_equal, "not_bit_equal_max_abs_err": worst,
                "step1_leaves_not_bit_equal_to_the_update_of_stream_grads": update_not_equal,
                "tolerance": tol(torch.bfloat16), "stream_grads": grads_stats,
                "stream_grads_launches": used, "pin_s": pin_s, "host_before": before,
                "host_after_pinning": held, "reckoned_device_bytes": stream_reckoned(hp, cfg),
                "steps": steps, "losses": losses, "card": card}, launches
    finally:
        hp.close()
        release()


def stream_deep(dev, card, arch, layers, link, rate, avail_at_start):
    """(c) mixtral-8x7b at as many of its layers as MemAvailable holds with
    STREAM_HOST_MARGIN to spare, (d) arctic-480b at ``layers`` (cut the same
    way if the host lacks the memory), each also at no more layers than its
    steps can update in STREAM_DEEP_BUDGET_S at ``rate`` elements/s (and at
    no fewer than STREAM_DEEP_MIN_LAYERS of those asked for): every
    layer drawn on the card from the seed (0, l) through ``init`` of a
    one-layer configuration and copied into its pinned buffer, then
    STREAM_DEEP_STEPS steps."""
    full = get_config(arch)
    one = _cut(arch, 1)
    meta = tfm.init(None, one, dtype=torch.bfloat16, device="meta")
    layer_bytes = streaming._Layout(meta["blocks"][0]).nbytes
    top_bytes = streaming._Layout({k: v for k, v in meta.items() if k != "blocks"}).nbytes
    fixed = top_bytes + streaming.STAGING_CHUNKS * streaming.STAGING_BYTES
    want = min(layers or full.num_layers, full.num_layers)
    # pinned pages come back to MemAvailable some seconds late: wait for what
    # this case asks for, or for what the phase started with
    waited, _ = wait_for_host_memory(min(fixed + want * layer_bytes + STREAM_HOST_MARGIN,
                                         avail_at_start - (4 << 30)))
    avail = streaming.mem_available_bytes()
    memory_fit = (avail - STREAM_HOST_MARGIN - fixed) // layer_bytes
    # the budget cuts depth, never below STREAM_DEEP_MIN_LAYERS
    time_fit = max(min(want, STREAM_DEEP_MIN_LAYERS),
                   int(STREAM_DEEP_BUDGET_S * rate // (STREAM_DEEP_STEPS * layer_bytes // 2)))
    n = int(min(want, memory_fit, time_fit))
    cut = {"asked_layers": want, "layers": n, "MemAvailable": avail,
           "waited_for_host_memory_s": waited, "margin": STREAM_HOST_MARGIN,
           "layer_bytes": layer_bytes, "top_bytes": top_bytes,
           "pinned_bytes_for_asked": fixed + want * layer_bytes, "memory_fits": int(memory_fit),
           "budget_s": STREAM_DEEP_BUDGET_S, "update_elements_per_s": rate,
           "time_fits": time_fit}
    print(f"chip_smoke: stream {arch}: {n} of {want} layers (MemAvailable {avail} B holds "
          f"{memory_fit} with {STREAM_HOST_MARGIN} B kept free, each layer {layer_bytes} B; "
          f"{STREAM_DEEP_BUDGET_S} s of host update at {rate:.3e} elements/s covers {time_fit})",
          flush=True)
    if n < 1:
        raise AssertionError(f"stream {arch}: no layer fits the host: {cut}")
    cfg = _cut(arch, n)
    gen = torch.Generator(device=dev)

    def draw(l):
        gen.manual_seed(int(np.random.SeedSequence((0, l)).generate_state(1)[0]))
        return tfm.init(gen, one, dtype=torch.bfloat16, device=dev)

    top = {k: v for k, v in draw(0).items() if k != "blocks"}
    before = host_status()
    t0 = time.perf_counter()
    hp = HostParams({**top, "blocks": lambda l: draw(l)["blocks"][0]}, n, device=dev)
    build_s = time.perf_counter() - t0
    held = host_status()
    top = None
    release()
    try:
        batch = stream_batch(cfg)
        steps, launches = stream_steps(dev, hp, cfg, batch, STREAM_DEEP_STEPS, link)
        return {"config": f"{cfg.name} full width, {n} of {full.num_layers} layers, bf16, "
                          f"B {STREAM_BATCH[0]} x S {STREAM_BATCH[1]} of SyntheticLM, "
                          f"lr {STREAM_LR}, every layer drawn on the card one at a time",
                "cut": cut, "parameters_per_layer": layer_bytes // 2,
                "build_and_pin_s": build_s, "host_before": before, "host_after_pinning": held,
                "pinned_bytes": hp.pinned_bytes,
                "reckoned_device_bytes": stream_reckoned(hp, cfg), "steps": steps,
                "losses": [s["loss"] for s in steps], "card": card}, launches
    finally:
        hp.close()
        release()


def phase_stream(dev, card):
    """Weight streaming: the link, (a)-(c) against the monolithic gradient,
    then (c) mixtral at the depth the host holds and (d) arctic-480b.
    Returns each case's launches."""
    report = {"phase": "stream", "card": card, "threads": torch.get_num_threads(),
              "host_at_start": host_status(), "link": stream_link(dev)}
    launches, rates = {}, []
    for arch, layers in STREAM_COMPARE:
        name = arch if layers is None else f"{arch}_{layers}"
        report[name], launches[f"stream_{name}"] = stream_compare(dev, card, arch, layers,
                                                                  report["link"])
        rates += [s["update_elements_per_s"] for s in report[name]["steps"]]
    # the host update's rate in (a)-(c), which sets the deep cases' pace
    rate = statistics.median(rates)
    for arch, layers in STREAM_DEEP:
        name = f"{arch}_deep"
        report[name], launches[f"stream_{name}"] = stream_deep(
            dev, card, arch, layers, report["link"], rate,
            report["host_at_start"]["MemAvailable"])
    report["host_at_end"] = host_status()
    emit(report)
    return launches


MOE_RANGES = ("moe_ffn", "moe_dispatch", "moe_combine")


def moe_ranges():
    """While active, the MoE FFN and its dispatch (routing, bucket slots, the
    scatter into the buckets) and combine (the gather back) run inside
    torch.profiler ranges named after MOE_RANGES, so that the device time of
    their kernels can be told apart from the attention block's."""
    from torch.profiler import record_function

    def ranged(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run
    return patched(moe, moe_ffn=ranged("moe_ffn", moe.moe_ffn),
                   _group_dispatch=ranged("moe_dispatch", moe._group_dispatch),
                   _group_combine=ranged("moe_combine", moe._group_combine))


# --------------------------------------------------------------------------
# the launch tools: the dry run's records measured on the card
# --------------------------------------------------------------------------

LAUNCH_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts", "launch")
# (case, arch, shape, mesh, perf variant or None, whether the reckoning must
# take the full depth, the kernels each counted step must launch): (a)
# llama3.2-1b's train cell at L1, L2 and full depth; (b) mamba2-1.3b's
# prefill, the SSD kernel at S 32768; (c) mixtral-8x7b's decode over pod x
# data x model, probe depths only (a layer is 2.8 GB: 32 do not fit; a decode
# step attends without the flash kernel); (f) one perf.PLAN variant at the
# probe depths
LAUNCH_TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "tree_reduce")
LAUNCH_CELLS = [("a", "llama3.2-1b", "train_4k", "single", None, True, LAUNCH_TRAIN_KERNELS),
                ("b", "mamba2-1.3b", "prefill_32k", "single", None, True,
                 ("ssd_scan", "tree_reduce")),
                ("c", "mixtral-8x7b", "decode_32k", "multi", None, False, ("tree_reduce",)),
                ("f", "chatglm3-6b", "train_4k", "single", "v1_no_tp_fsdp256", False,
                 LAUNCH_TRAIN_KERNELS)]
# (a'): one step of a reduced llama3.2-1b (head dim 64, the flash kernel's
# smallest) counted on the card and on the CPU, over data 2 x model 2
LAUNCH_PARITY = dict(d_model=256, head_dim=64, d_ff=512, vocab_size=1024, num_layers=2)
LAUNCH_PARITY_SHAPE = ShapeConfig("t", "train", 256, 4)


def _write_record(name, rec):
    os.makedirs(LAUNCH_OUT, exist_ok=True)
    path = os.path.join(LAUNCH_OUT, f"{name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    return os.path.relpath(path, os.path.dirname(os.path.abspath(__file__)))


def _run_summary(run):
    return {"layers": run["layers"], "step_s": run["seconds"]["step"],
            "first_step_s": run["seconds"]["first_step"], "setup_s": run["seconds"]["setup"],
            "peak_bytes_per_rank": run["peak_bytes_per_rank"],
            "flops_per_device": run["cost"]["flops"],
            "bytes_per_device": run["cost"]["bytes accessed"],
            "collective_bytes_per_device": run["collectives"]["per_kind_bytes"],
            "counted_step_launches": {k: v for k, v in run["launches"].items() if v}}


def launch_cell(dev, case, arch, shape, mesh, variant, full, kernels):
    """One dry-run cell on the card: the record written, one summary line
    emitted, the probe checked exact where the full depth ran, each of
    ``kernels`` launched in every counted step."""
    overrides = None
    if variant:
        overrides = next(o for a, s_, v, _, o in perf.PLAN
                         if (a, s_, v) == (arch, shape, variant))
    rec = dryrun.run_cell(arch, shape, mesh, pcfg_overrides=overrides, device=dev)
    if rec["status"] != "ok":
        raise AssertionError(f"launch ({case}) {arch} {shape}: {rec['status']}")
    if rec["reduced"]["full_depth"] != full:
        raise AssertionError(f"launch ({case}) {arch} {shape}: full depth "
                             f"{rec['reduced']['full_depth']}, expected {full} "
                             f"({rec['reduced']['full_depth_reckoned_bytes']} bytes reckoned)")
    runs = {k: rec["probe"][k] for k in ("L1", "L2")}
    if full:
        runs["full"] = rec["full"]
        want = {"flops": rec["full"]["cost"]["flops"],
                "bytes_accessed": rec["full"]["cost"]["bytes accessed"],
                "collective_bytes": rec["full"]["collective_bytes"]}
        if rec["corrected"] != want:
            raise AssertionError(f"launch ({case}): corrected {rec['corrected']} != the "
                                 f"full depth's count {want}")
    for name, run in runs.items():
        missing = [k for k in kernels if not run["launches"][k]]
        if missing:
            raise AssertionError(f"launch ({case}) {name}: no launch of {missing} in the "
                                 f"counted step ({run['launches']})")
    path = _write_record(f"{arch}__{shape}__{variant or mesh}", rec)
    emit({"phase": "launch", "case": case, "arch": arch, "shape": shape, "mesh": mesh,
          "variant": variant, "record": path, "reduced": rec["reduced"],
          "memory_per_device": rec["memory_per_device"], "corrected": rec["corrected"],
          "corrected_equals_full_depth": full or None,
          "roofline": {k: rec["roofline"][k] for k in ("compute_s", "memory_s", "collective_s",
                                                      "dominant", "roofline_fraction")},
          "runs": {k: _run_summary(r) for k, r in runs.items()}})
    return rec


def launch_parity(dev, card):
    """(a'): one reduced llama3.2-1b step counted on the card and on the CPU:
    FLOPs, bytes and collective bytes equal, and each op's count (an op that
    differs is named)."""
    cfg = get_config("llama3.2-1b").reduced(**LAUNCH_PARITY)
    shape = LAUNCH_PARITY_SHAPE
    card_run, cpu_run = (
        dryrun.measure_step(cfg, shape, mesh, *dryrun.cell_policy(cfg, shape, mesh), timed=1,
                            by_op=True)
        for mesh in (dryrun.card_mesh("single", where) for where in (dev, "cpu")))
    if card_run["cost"]["flops"] != cpu_run["cost"]["flops"]:
        raise AssertionError(f"launch (a'): flops card {card_run['cost']['flops']} != CPU "
                             f"{cpu_run['cost']['flops']}")
    if card_run["collectives"] != cpu_run["collectives"]:
        raise AssertionError(f"launch (a'): collectives card {card_run['collectives']} != "
                             f"CPU {cpu_run['collectives']}")
    a, b = card_run["cost"]["by_op"], cpu_run["cost"]["by_op"]
    differ = {op: {"card": a.get(op), "cpu": b.get(op)} for op in sorted(set(a) | set(b))
              if a.get(op) != b.get(op)}
    if differ or card_run["cost"]["bytes accessed"] != cpu_run["cost"]["bytes accessed"]:
        raise AssertionError(f"launch (a'): ops counted otherwise on the card and the CPU: "
                             f"{differ}")
    if not card_run["launches"]["flash_attention"]:
        raise AssertionError("launch (a'): no flash launch on the card")
    emit({"phase": "launch", "case": "a'", "card": card,
          "config": {**LAUNCH_PARITY, "shape": dataclasses.asdict(shape)},
          "flops": card_run["cost"]["flops"],
          "bytes": {"card": card_run["cost"]["bytes accessed"],
                    "cpu": cpu_run["cost"]["bytes accessed"]},
          "collectives": card_run["collectives"], "ops": len(a),
          "card_launches": {k: v for k, v in card_run["launches"].items() if v}})


def phase_launch(dev, card):
    """The launch tools on the card: the dry-run cells (LAUNCH_CELLS), the
    card-against-CPU count (a'), ep_compare (d) and serving_compare (e).
    Returns each case's launches, every step of the case (warm-up, counted,
    timed) counted."""
    used = {}
    for case, *cell in LAUNCH_CELLS[:1]:
        _zero_launches()
        launch_cell(dev, case, *cell)
        used[case] = _launches()
        release()
    launch_parity(dev, card)
    release()
    for case, *cell in LAUNCH_CELLS[1:3]:
        _zero_launches()
        launch_cell(dev, case, *cell)
        used[case] = _launches()
        release()
    ep = dryrun.ep_compare(device=dev)
    if ep["measured_over_bucket"] != 1:
        raise AssertionError(f"launch (d): measured / bucket {ep['measured_over_bucket']}")
    emit({"phase": "launch", "case": "d", "record": _write_record("ep_compare", ep), **ep})
    serving = dryrun.serving_compare(device=dev)
    if serving["analytical"] is not None or not serving["measured"]["decode_step_p50_s"] > 0:
        raise AssertionError(f"launch (e): {serving}")
    emit({"phase": "launch", "case": "e", "record": _write_record("serving_compare", serving),
          **serving})
    release()
    for case, *cell in LAUNCH_CELLS[3:]:
        _zero_launches()
        launch_cell(dev, case, *cell)
        used[case] = _launches()
        release()
    return used


def _device_time_by_kernel(fn):
    """Run ``fn`` under torch.profiler; (wall ms, {kernel name: device ms},
    {MoE range: device ms of the kernels that start inside it}).  The
    profiler puts each range on the device's timeline too (a span from its
    first kernel to its last); those spans are not kernels: they are left out
    of the kernel times and used only to attribute kernels to ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, spans, kernels = {}, {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        tr = e.time_range
        if e.name in MOE_RANGES:
            spans.setdefault(e.name, []).append((tr.start, tr.end))
            continue
        by_name[e.name] = by_name.get(e.name, 0.0) + tr.elapsed_us() / 1e3
        kernels.append((tr.start, tr.elapsed_us()))
    ranges = {name: sum(d for t, d in kernels if any(a <= t < b for a, b in sp)) / 1e3
              for name, sp in spans.items()}
    return wall_ms, by_name, ranges


def _summarise(wall_ms, by_name, ranges=None):
    groups = {"flash_attention kernel": 0.0, "flash_attention backward kernels": 0.0,
              "ssd_scan kernel": 0.0, "ssd_scan backward kernels": 0.0,
              "tree_reduce kernel": 0.0, "quantize / dequantize kernels": 0.0,
              "matrix products (library)": 0.0, "copies": 0.0,
              "sort, scatter, gather, index (library)": 0.0,
              "elementwise and other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        if "flash_fwd" in low:
            groups["flash_attention kernel"] += ms
        elif "flash_bwd" in low or "bwd_delta" in low:
            groups["flash_attention backward kernels"] += ms
        elif "ssd_bwd" in low:
            groups["ssd_scan backward kernels"] += ms
        elif "ssd_scan" in low:
            groups["ssd_scan kernel"] += ms
        elif "tree_reduce" in low:
            groups["tree_reduce kernel"] += ms
        elif "quantize" in low:
            groups["quantize / dequantize kernels"] += ms
        elif any(w in low for w in ("gemm", "gemv", "cutlass", "nvjet", "xmma", "cublas")):
            groups["matrix products (library)"] += ms
        elif "memcpy" in low or "memset" in low:
            groups["copies"] += ms
        elif any(w in low for w in ("sort", "scatter", "gather", "index")):
            groups["sort, scatter, gather, index (library)"] += ms
        else:
            groups["elementwise and other"] += ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    # the hand-written kernels one by one (the flash backward is three: D
    # pass, dK/dV, dQ; the SSD backward four: chains, chunk, two sums), by
    # the function name inside the demangled signature
    own = {}
    for name, ms in by_name.items():
        m = re.search(r"\w*(flash_fwd|bwd_delta|flash_bwd|ssd_scan|ssd_bwd|tree_reduce|quantize)\w*"
                      r"(<[^>]*>)?", name)
        if m:
            own[m.group(0)] = own.get(m.group(0), 0.0) + ms
    out = {}
    if ranges:
        # the forward's MoE FFN (with block remat, its recompute too; the
        # backward's kernels run outside these ranges and sit in the groups)
        ffn = ranges.get("moe_ffn", 0.0)
        dsp, cmb = ranges.get("moe_dispatch", 0.0), ranges.get("moe_combine", 0.0)
        out["moe_forward_ms"] = {"ffn": ffn, "dispatch": dsp, "combine": cmb,
                                 "expert_products_and_rest": ffn - dsp - cmb}
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms else None,
            **out,
            "groups_ms": groups,
            "hand_written_kernels_ms": own,
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def phase_profile(dev, arch, layers=None, prompt=2048):
    """Optional (``--phases profile``): where one prefill and four decode
    steps of a served model (at ``layers`` layers if given; llava's prompts
    after its patches) spend their device time."""
    cfg = _cut(arch, layers)
    params = tfm.init(0, cfg, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, prompt))).to(dev)
    extras = model_inputs(cfg, 8, 1)
    batch = {"tokens": toks, **on(extras, dev, torch.bfloat16)}
    enc_fn = _enc_fn(cfg, ParallelConfig())
    nxt = toks[:, :1]
    with torch.inference_mode():
        _, st = tfm.prefill(params, batch, cfg, None, 4096, enc_fn=enc_fn)   # warm-up
        for _ in range(2):
            _, st = tfm.decode_step(params, nxt, st, cfg, None)
        state = [st]

        def four_steps():
            for _ in range(4):
                _, state[0] = tfm.decode_step(params, nxt, state[0], cfg, None)
        with moe_ranges():
            pre = _summarise(*_device_time_by_kernel(
                lambda: tfm.prefill(params, batch, cfg, None, 4096, enc_fn=enc_fn)))
            dec = _summarise(*_device_time_by_kernel(four_steps))
    emit({"phase": "profile", "config": cfg.name, "layers": cfg.num_layers, "batch": 8,
          "prompt": prompt, **{k: a.shape[1] for k, a in extras.items()},
          "prefill": pre, "decode_4_steps": dec})
    del params, st, state, batch
    torch.cuda.empty_cache()


def phase_profile_train(dev, arch, layers=None):
    """Optional (``--phases profile``): where one train step of ``arch`` at
    the train phase's configuration spends its device time (two steps first,
    unprofiled, to warm up)."""
    cfg = _cut(arch, layers)
    B, S = TRAIN_SHAPE["B"], TRAIN_SHAPE["S"]
    tr = Trainer(cfg, ShapeConfig("train_4x2048", "train", S, B),
                 ParallelConfig(remat="block", param_dtype="bfloat16"), OptimConfig(),
                 device=dev)
    state = tr.init_state()
    for i in range(2):
        state, _ = tr.step_fn(state, tr.data.batch(i))
    batch = tr.data.batch(2)
    box = [state]

    def one_step():
        box[0], metrics = tr.step_fn(box[0], batch)
        float(metrics["loss"])
    with moe_ranges():
        summary = _summarise(*_device_time_by_kernel(one_step))
    emit({"phase": "profile", "config": f"{cfg.name} train step, B {B} x S {S}, block remat",
          "layers": cfg.num_layers, "train_step": summary})
    del state, box, tr
    torch.cuda.empty_cache()


def phase_profile_prefix_train(dev, arch, layers, B, S):
    """Optional (``--phases profile``): where one train step of a
    TRAIN_PREFIX cell spends its device time (two steps first, unprofiled)."""
    cfg, _, state, step, batch = prefix_train_setup(dev, arch, layers, B, S)
    for _ in range(2):
        state, _ = step(state, batch)
    box = [state]

    def one_step():
        box[0], metrics = step(box[0], batch)
        float(metrics["loss"])
    summary = _summarise(*_device_time_by_kernel(one_step))
    emit({"phase": "profile", "config": f"{cfg.name} train step, B {B} x {S} tokens, block "
                                        f"remat, make_train_step",
          "layers": cfg.num_layers, "encoder_layers": cfg.n_enc_layers or None,
          "train_step": summary})
    del state, box, step, batch
    torch.cuda.empty_cache()


@contextlib.contextmanager
def phase_limit(name, seconds):
    """Run the body under PHASE_LIMIT_S[name]; record its wall time."""
    done = threading.Event()

    def watch():
        if not done.wait(PHASE_LIMIT_S[name]):
            print(f"chip_smoke: phase {name} ran past its limit of "
                  f"{PHASE_LIMIT_S[name]} s", file=sys.stderr, flush=True)
            os._exit(3)
    watcher = threading.Thread(target=watch, daemon=True)
    t0 = time.perf_counter()
    watcher.start()
    try:
        yield
    finally:
        done.set()
        watcher.join()
        seconds[name] = round(seconds.get(name, 0.0) + time.perf_counter() - t0, 3)


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

    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}
    with phase_limit("env", seconds):
        card = phase_env()
    with phase_limit("build", seconds):
        phase_build()     # every later phase needs the kernels
    entries = []
    if "kernels" in phases:
        with phase_limit("kernels", seconds):
            entries = phase_kernels(dev)
    if "parity" in phases:
        with phase_limit("parity", seconds):
            phase_parity(dev)
    # each main path is read with the counts set to 0 just before it
    launches = {}
    if "serve" in phases:
        with phase_limit("serve", seconds):
            launches["flash_attention_fwd"] = phase_serve(dev, "llama3.2-1b")["flash_attention"]
            launches["ssd_scan_fwd"] = phase_serve(dev, "mamba2-1.3b")["ssd_scan"]
            for arch, layers, long_prompt in SERVE_MOE:
                used = phase_serve(dev, arch, layers=layers, long_prompt=long_prompt)
                if long_prompt:
                    launches["flash_attention_fwd_window"] = used["flash_attention"]
            for cell in SERVE_PREFIX:
                # the last cell, whisper's: encoder, self- and cross-attention
                launches["flash_attention_fwd_cross"] = serve_prefix(dev, *cell)["flash_attention"]
    if "sync" in phases:
        with phase_limit("sync", seconds):
            used = phase_sync(dev, profile="profile" in phases)
        for name in ("tree_reduce", "quantize_int8", "dequantize_int8"):
            launches[name] = used[name]
    if "train" in phases:
        with phase_limit("train", seconds):
            launches.update(phase_train(dev, card))
    pipeline_launches = {}
    if "parallel" in phases:
        with phase_limit("parallel", seconds):
            used = phase_parallel(dev, card)
        pipeline_launches = {"flash_attention_fwd": used["flash_attention"],
                             "flash_attention_bwd": used["flash_attention_bwd"]}
    setup_launches = {}
    if "setup" in phases:
        with phase_limit("setup", seconds):
            for case, used in phase_setup(dev, card).items():
                for name, key in (("flash_attention_fwd", "flash_attention"),
                                  ("flash_attention_bwd", "flash_attention_bwd"),
                                  ("ssd_scan_fwd", "ssd_scan"), ("ssd_scan_bwd", "ssd_scan_bwd"),
                                  ("tree_reduce", "tree_reduce")):
                    if used[key]:
                        setup_launches.setdefault(name, {})[case] = used[key]
    stream_launches = {}
    if "stream" in phases:
        with phase_limit("stream", seconds):
            for case, used in phase_stream(dev, card).items():
                for name, key in (("flash_attention_fwd", "flash_attention"),
                                  ("flash_attention_bwd", "flash_attention_bwd"),
                                  ("ssd_scan_fwd", "ssd_scan"), ("ssd_scan_bwd", "ssd_scan_bwd")):
                    if used[key]:
                        stream_launches.setdefault(name, {})[case] = used[key]
    launch_launches = {}
    if "launch" in phases:
        with phase_limit("launch", seconds):
            for case, used in phase_launch(dev, card).items():
                for name, key in (("flash_attention_fwd", "flash_attention"),
                                  ("flash_attention_bwd", "flash_attention_bwd"),
                                  ("ssd_scan_fwd", "ssd_scan"), ("ssd_scan_bwd", "ssd_scan_bwd"),
                                  ("tree_reduce", "tree_reduce")):
                    if used[key]:
                        launch_launches.setdefault(name, {})[case] = used[key]
    if "profile" in phases:
        with phase_limit("profile", seconds):
            for arch in ("llama3.2-1b", "mamba2-1.3b"):
                phase_profile(dev, arch)
            phase_profile(dev, SERVE_MOE[0][0], layers=SERVE_MOE[0][1])
            for arch in (TRAIN_ARCH, SSM_TRAIN_ARCH):
                phase_profile_train(dev, arch)
            phase_profile_train(dev, MOE_TRAIN_ARCH, layers=MOE_TRAIN_LAYERS)
            phase_profile(dev, SERVE_PREFIX[0][0], layers=SERVE_PREFIX[0][1],
                          prompt=SERVE_PREFIX[0][2])
            phase_profile_prefix_train(dev, *TRAIN_PREFIX[1])
    emit({"phase_seconds": seconds, "limits": {k: PHASE_LIMIT_S[k] for k in seconds}})

    full = set(PHASES) <= set(phases)
    for entry in entries:
        entry["launches"] = launches.get(entry["name"])
        if entry["name"] in pipeline_launches:
            entry["pipeline_launches"] = pipeline_launches[entry["name"]]
        if entry["name"] in setup_launches:
            entry["setup_launches"] = setup_launches[entry["name"]]
        if entry["name"] in stream_launches:
            entry["stream_launches"] = stream_launches[entry["name"]]
        if entry["name"] in launch_launches:
            entry["launch_launches"] = launch_launches[entry["name"]]
        entry["card"] = card
        if full and not entry["launches"]:
            raise AssertionError(f"{entry['name']}: no launch on its main path")
    print(card, flush=True)
    emit({"kernels": entries})
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
