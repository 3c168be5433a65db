"""Roofline terms of one cell on one NVIDIA H100, and the counter that reads
a step's FLOPs and bytes off its run.

Counterpart of ``repro.launch.roofline``, which reads XLA's compiled
artifacts: ``cost_analysis()`` for FLOPs and bytes accessed, the optimized HLO
for the collectives' bytes.  Eager PyTorch has neither, so the port counts
what a step runs:

* ``count_cost()`` — a ``TorchDispatchMode`` over the step: the FLOPs of every
  aten op by ``torch.utils.flop_counter``'s formulas (products and
  convolutions; elementwise ops count none), and its bytes as the bytes its
  inputs span plus the bytes its outputs span (eager HBM traffic: each op
  reads its inputs from memory and writes its outputs there).  A view or an
  ``empty*`` counts nothing; an ``expand`` view counts its source's bytes once,
  not its logical size.  The hand-written kernels launch through ``ctypes``
  and are invisible to a dispatch mode, so each call reports the formula
  beside its wrapper, and the ops inside the call (the plain version's, on the
  CPU) count nothing (``kernels.work``): one step counts the same on the card
  and on the CPU.
* ``launch.mesh.count_collectives()`` — the bytes of the mesh's collectives,
  the counterpart of ``collective_bytes_from_hlo``.

The XLA helpers (``collective_bytes_from_hlo``, ``collective_op_bytes``,
``_split_computations``, ``_multipliers``, ``collect_cost``) have no copy
here: those two counters stand in for them.

``param_counts``, ``model_flops``, ``exposed_comm_s`` and ``roofline_terms``
are copies of the JAX package's, line for line; only the hardware constants
are the H100's.

The collectives' own traffic (``c10d`` ops) is ``count_collectives``', not
counted here.

Per device: on a ``StackedMesh`` every rank runs on the one card, so a
``count_cost`` of a step covers every stacked rank, and a rank's share is the
count divided by the ranks (``count_cost(ranks=)``); on a ``DistMesh`` each
process counts its own rank.  The two differ by what one transport runs and
the other does not: the stacked mesh holds a replicated operand or leaf once
(an ``expand`` of it counts its source once) where each rank holds and reads
its own, EP's lanes share work there, and remat's rerun can stop a product
earlier on a rank.  ``tools/count_parity.py`` measures it on reduced setups.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import work

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core peak (the figure of
# chip_smoke.py's bounds and of TrainerConfig's MFU), 989.4 TFLOP/s
PEAK_FLOPS = 989e12          # bf16 / card
# the same data sheet: HBM3 bandwidth of the 80 GB SXM5 card
HBM_BW = 3.35e12             # B/s / card
# NVLink 4 on the same data sheet: 900 GB/s a card both ways, 450 GB/s one
# way.  A bound only: no link is measured on one card.
LINK_BW = 450e9              # B/s / card, one direction

_aten = torch.ops.aten
# count nothing: allocations (they write no memory) and the view a reshape
# takes of a fresh result, which its schema does not mark as one
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
         _aten.new_empty_strided, _aten._unsafe_view}


def _is_view(func) -> bool:
    """Whether every output of an aten op aliases an input without writing
    it: a view, which moves no byte."""
    returns = func._schema.returns
    return bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                 for r in returns)


def span_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor spans: each distinct element once (a dimension of
    stride 0, an ``expand``'s, counts one element)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


class CostCounter:
    """FLOPs and bytes so far; ``muted`` > 0 while a kernel call runs;
    ``by_op`` (when kept) [calls, FLOPs, bytes] by aten op or kernel."""

    def __init__(self, by_op: bool = False):
        self.flops = 0
        self.bytes = 0
        self.muted = 0
        self.by_op = {} if by_op else None

    def add(self, flops, nbytes, name: str = "") -> None:
        self.flops += flops
        self.bytes += nbytes
        if self.by_op is not None:
            row = self.by_op.setdefault(name, [0, 0, 0])
            row[0] += 1
            row[1] += flops
            row[2] += nbytes


class _CostMode(TorchDispatchMode):
    def __init__(self, counter: CostCounter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.counter
        packet = func._overloadpacket
        if c.muted or packet in _FREE or func.namespace == "c10d" or _is_view(func):
            return out
        formula = flop_registry.get(packet)
        c.add(formula(*args, **kwargs, out_val=out) if formula is not None else 0,
              sum(span_bytes(t) for t in tree_leaves((args, kwargs, out))
                  if isinstance(t, torch.Tensor)), str(packet))
        return out


@contextlib.contextmanager
def count_cost(ranks: int = 1, by_op: bool = False):
    """Count the FLOPs and bytes of what runs inside; yields a dict that holds
    ``{"flops", "bytes accessed"}`` (``collect_cost``'s keys) once the block
    ends, each divided by ``ranks`` (the stacked ranks: a rank's share), and
    with ``by_op`` also ``"by_op"``: {aten op or kernel work: [calls, FLOPs,
    bytes]}, undivided.  One counter at a time."""
    if work.counter is not None:
        raise RuntimeError("count_cost: a count is already running")
    counter, rec = CostCounter(by_op), {}
    work.counter = counter
    try:
        with _CostMode(counter):
            yield rec
    finally:
        work.counter = None
    rec["flops"] = counter.flops / ranks
    rec["bytes accessed"] = counter.bytes / ranks
    if by_op:
        rec["by_op"] = counter.by_op


# --------------------------------------------------------------------------
# model FLOPs & terms (copies of the JAX package's)
# --------------------------------------------------------------------------

def param_counts(cfg) -> Tuple[int, int]:
    """(total, active) parameter counts, computed analytically."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    L = cfg.num_layers

    def attn_params():
        return d * (cfg.n_heads * cfg.head_dim) * 2 + \
            d * (cfg.n_kv_heads * cfg.head_dim) * 2

    def mlp_params(ff):
        return 3 * d * ff

    total = active = 2 * V * d if not cfg.tie_embeddings else V * d
    if cfg.family in ("ssm", "hybrid"):
        di = cfg.d_inner
        per = d * (2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads) \
            + di * d + 4 * (di + 2 * cfg.ssm_groups * cfg.ssm_state)
        total += per * L
        active += per * L
        if cfg.family == "hybrid":
            shared = attn_params() + mlp_params(f)
            uses = L // cfg.attn_every
            total += shared
            active += shared * uses   # applied `uses` times per token
    elif cfg.n_experts:
        per_expert = mlp_params(f)
        per_layer = attn_params() + cfg.n_experts * per_expert + d * cfg.n_experts
        per_layer_active = attn_params() + cfg.top_k * per_expert + d * cfg.n_experts
        if cfg.moe_dense_ff:
            per_layer += mlp_params(cfg.moe_dense_ff)
            per_layer_active += mlp_params(cfg.moe_dense_ff)
        total += per_layer * L
        active += per_layer_active * L
    else:
        per = attn_params() + mlp_params(f)
        total += per * L
        active += per * L
    if cfg.family == "audio":
        enc = (attn_params() + mlp_params(f)) * cfg.n_enc_layers
        # decoder cross-attention
        total += enc + attn_params() * L
        active += enc + attn_params() * L
    return int(total), int(active)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS per the task spec: 6·N·D train (N=active params,
    D=tokens), 2·N·D for single forward (prefill/decode)."""
    _, active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * active * tokens


def exposed_comm_s(comm_s: float, overlappable_compute_s: float) -> float:
    """Exposed (non-hidden) communication time under an overlap budget:
    communication hides behind up to ``overlappable_compute_s`` of
    independent compute, and only the excess lands on the critical path,
    ``max(0, comm − overlappable)``."""
    return max(0.0, comm_s - overlappable_compute_s)


def roofline_terms(rec: dict, cfg, shape,
                   comm_overlap_fraction: float = 0.0) -> dict:
    chips = rec.get("n_devices", 1)
    corrected = rec.get("corrected") or {}
    flops_pd = corrected.get("flops") or rec["cost_analysis"].get("flops", 0.0)
    bytes_pd = corrected.get("bytes_accessed") or \
        rec["cost_analysis"].get("bytes accessed", 0.0)
    coll_pd = corrected.get("collective_bytes") or \
        rec["collectives"]["total_bytes"]

    t_compute = flops_pd / PEAK_FLOPS
    t_memory = bytes_pd / HBM_BW
    t_collective = coll_pd / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dominant = max(terms, key=terms.get)

    mf = model_flops(cfg, shape)
    hlo_total = flops_pd * chips
    useful = mf / hlo_total if hlo_total else 0.0
    bound = max(terms.values())
    # roofline fraction: useful model FLOPs over the time the dominant
    # term implies, relative to the all-chips peak
    frac = (mf / (chips * PEAK_FLOPS)) / bound if bound else 0.0
    return {**terms,
            "exposed_comm_s": exposed_comm_s(
                t_collective, comm_overlap_fraction * t_compute),
            "dominant": dominant.replace("_s", ""),
            "model_flops_total": mf,
            "hlo_flops_total": hlo_total,
            "useful_flops_ratio": useful,
            "roofline_fraction": frac}
