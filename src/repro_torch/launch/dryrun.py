"""Dry run of the (architecture x input shape x mesh) cells on the card.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each cell's
step on the production meshes, (data 16, model 16) and (pod 2, data 16,
model 16), and records XLA's memory and cost analyses and the collectives of
the optimized HLO.  One card cannot run those meshes, and eager PyTorch has no
compiler's analyses, so the port splits the record in two:

* **Placement on the production mesh** (``memory_per_device``): the cell's
  setup built on ``make_production_mesh`` on the meta device (nothing is
  allocated), at the full shape and depth; ``argument_bytes`` is the state
  (or parameters) and batch one rank holds, read from the setup's layout,
  ``alias_bytes`` what the step donates (a train step's state, a decode
  step's decode state), ``output_bytes`` what it returns.  ``temp_bytes`` is
  null: eager PyTorch has no buffer plan, so ``total_bytes`` (argument +
  output - alias) is a lower bound.
* **The measured run**: every rank of a ``StackedMesh`` on the card, with the
  production mesh's axes each cut to 2 (``(data 2, model 2)`` for ``single``,
  ``(pod 2, data 2, model 2)`` for ``multi``), the cell's sequence length, and
  of its global batch the fewest sequences that the batch axes divide.  The
  step runs at the probe depths L1 and L2 (``probe_layer_cost``) and at full
  depth where the reckoned bytes of its state and step fit the card
  (``reckoned_bytes``, before anything is allocated; an out-of-memory error
  is a failure).  Each run records its step time (the median over CUDA
  events of ``TIMED_STEPS`` steps after one warm-up step; on the CPU the
  host's clock), ``max_memory_allocated`` over the ranks, ``count_cost`` and
  ``count_collectives`` of one more step (per device), and each kernel's
  launches in that step.  ``corrected`` extrapolates the probes to full
  depth as the JAX tool does (``corrected_totals``, a copy), and
  ``roofline`` is ``roofline_terms`` on it with the H100's constants and the
  measured cell's batch and ranks.  Every cut is listed under ``reduced``.

``--autostrategy`` lets the FRED simulator's sweep
(``core.autostrategy.choose``, on the card) pick the cell's strategy: the
decision is recorded under ``"autostrategy"`` as the JAX tool records it
(``autostrategy_block``) and stamped on the recorded ``pcfg``.

``ep_compare`` measures the expert-parallel all-to-all of
``models.moe.moe_ffn_ep`` against its bucket and token payloads, and
``serving_compare`` the decode-step latency of the port's ``Engine`` on a
reduced llama3.2-1b beside the analytical column the simulator's serving
objective quotes for the full arch on wafer hardware
(``core.autostrategy.choose_serving_strategy``).

Usage (needs an NVIDIA GPU; the functions take ``device="cpu"`` for tests):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out artifacts/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import statistics
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..configs.registry import ARCH_IDS, get_config, shape_applicability
from ..kernels import flash_attention as _flash
from ..kernels import quant8 as _quant8
from ..kernels import reduce_tree as _tree
from ..kernels import ssd_scan as _ssd
from ..models import transformer as tfm
from ..models.config import SHAPES, SHAPES_BY_NAME, ShapeConfig
from ..models.modules import resolve_device, tree_flatten
from ..parallel import steps
from ..parallel.policy import cell_policy, paper_defaults
from ..parallel.sharding import Ruleset, _names
from .mesh import StackedMesh, count_collectives, make_production_mesh
from .roofline import count_cost, roofline_terms

# the production mesh's axes, each cut to 2, for the run on the card
CARD_MESHES = {"single": ((2, 2), ("data", "model")),
               "multi": ((2, 2, 2), ("pod", "data", "model"))}
TIMED_STEPS = 3
SEED = 0          # the parameters' and inputs' draws
# the reduced llama of serving_compare: the flash kernel's smallest head dim
# (the JAX tool's reduced copy has 16)
SERVING_HEAD_DIM = 64
# the share of the card's memory a full-depth run may reckon to hold
MEMORY_SHARE = 0.85
# the hand-written kernels' wrappers, by the name chip_smoke.py gives them
KERNELS = {"flash_attention": _flash.flash_attention,
           "flash_attention_bwd": _flash.flash_attention_bwd,
           "ssd_scan": _ssd.ssd_scan, "ssd_scan_bwd": _ssd.ssd_scan_bwd,
           "tree_reduce": _tree.tree_reduce, "quantize_int8": _quant8.quantize,
           "dequantize_int8": _quant8.dequantize}
# a train step's metrics (fp32 scalars), as the JAX step returns them
TRAIN_METRICS = ("loss", "aux_loss", "tokens", "grad_norm", "lr")


def _build_mesh(kind: str):
    """The production mesh of ``kind`` (meta device: placement only)."""
    return make_production_mesh(multi_pod=(kind == "multi"))


def card_mesh(kind: str, device="cuda") -> StackedMesh:
    """The mesh the measured run stacks on one device."""
    shape, axes = CARD_MESHES[kind]
    return StackedMesh(shape, axes, device)


def card_shape(cfg, shape: ShapeConfig, mesh, pcfg) -> ShapeConfig:
    """``shape`` with its global batch cut to the fewest sequences that the
    batch axes of ``mesh`` divide (one, where no batch axis divides it)."""
    axes = Ruleset(mesh, cfg, pcfg).batch_axes(shape.global_batch) or ()
    B = mesh.size(axes)
    got = Ruleset(mesh, cfg, pcfg).batch_axes(B) or ()
    if tuple(got) != tuple(axes):
        raise ValueError(f"{cfg.name} {shape.name}: a batch of {B} splits over {got}, "
                         f"the cell's over {axes}")
    return dataclasses.replace(shape, global_batch=B)


def at_depth(cfg, L: int):
    """``cfg`` at L layers (L applications of the shared block for the
    hybrid; the encoder cut to L too), as the JAX probe cuts it."""
    return dataclasses.replace(
        cfg, num_layers=L if cfg.family != "hybrid" else cfg.attn_every * L,
        n_enc_layers=min(cfg.n_enc_layers, L))


# --------------------------------------------------------------------------
# placement on the production mesh
# --------------------------------------------------------------------------

def _rank_bytes(t: torch.Tensor, spec, mesh) -> int:
    """Bytes of one rank's block of ``t`` placed by ``spec``."""
    spec = tuple(spec)
    n = t.element_size()
    for i, size in enumerate(t.shape):
        n *= -(-size // (mesh.size(_names(spec[i])) if i < len(spec) else 1))
    return n


def _tree_rank_bytes(shapes, specs, mesh) -> int:
    """One rank's bytes of a tree of tensors placed by a tree of specs (a
    spec a plain tuple; leaves that are no tensor, a decode state's index,
    count nothing)."""
    leaves = tree_flatten(shapes)[0]
    spec_leaves = tree_flatten(specs, is_leaf=lambda x: type(x) is tuple)[0]
    if len(leaves) != len(spec_leaves):
        raise AssertionError(f"{len(leaves)} leaves, {len(spec_leaves)} specs")
    return sum(_rank_bytes(t, s, mesh) for t, s in zip(leaves, spec_leaves)
               if torch.is_tensor(t))


def _state_rank_bytes(setup) -> int:
    """A train setup's state, as its layout holds it on one rank."""
    total = 0
    for t, held in zip(tree_flatten(setup.state_shapes)[0], setup.state_layout):
        if held.how == "rows":
            total += _rank_bytes(t, held.spec, setup.mesh)
        elif held.how == "scale":        # the rows' scales: the q's spec without its last
            total += _rank_bytes(t, tuple(held.spec)[:t.dim()], setup.mesh)
        else:
            total += t.numel() * t.element_size()
    return total


def _params_rank_bytes(setup) -> int:
    """A serving setup's parameters: the rows form of their specs where the
    setup holds them so (fsdp, TP, EP), else whole."""
    pcfg, ruleset = setup.pcfg, setup.ruleset
    held = pcfg.param_sharding == "fsdp" or steps._tp_axis(ruleset) or ruleset.ep_axis
    if held:
        return _tree_rank_bytes(setup.param_shapes, setup.param_shardings, setup.mesh)
    return sum(t.numel() * t.element_size() for t in tree_flatten(setup.param_shapes)[0])


def memory_per_device(setup) -> dict:
    """The bytes one rank holds of a cell's step arguments, outputs and
    donations, from the setup's placement (built on the meta device)."""
    cfg, shape, mesh = setup.cfg, setup.shape, setup.mesh
    batch = steps.input_specs(cfg, shape, setup.pcfg)
    batch_bytes = _tree_rank_bytes(batch, steps.batch_shardings(cfg, shape, setup.ruleset),
                                   mesh)
    cdt = steps.DTYPES[setup.pcfg.compute_dtype]
    logits = shape.global_batch * cfg.padded_vocab * torch.empty((), dtype=cdt).element_size()
    if shape.kind == "train":
        state = _state_rank_bytes(setup)
        argument, alias, output = state + batch_bytes, state, state + 4 * len(TRAIN_METRICS)
    else:
        # the index (a host int here) as the JAX state's int32 scalar
        dstate = _tree_rank_bytes(
            tfm.init_decode_state(cfg, shape.global_batch, shape.seq_len, cdt, device="meta"),
            setup.state_shardings, mesh) + 4
        params = _params_rank_bytes(setup)
        argument = params + batch_bytes + (dstate if shape.kind == "decode" else 0)
        alias = dstate if shape.kind == "decode" else 0
        output = logits + dstate       # the logits whole, as the port returns them
    return {"argument_bytes": argument, "output_bytes": output, "temp_bytes": None,
            "temp_why": "eager PyTorch has no compiler's buffer plan to read a step's "
                        "temporaries from; total_bytes leaves them out",
            "alias_bytes": alias, "total_bytes": argument + output - alias,
            "total_is": "a lower bound"}


# --------------------------------------------------------------------------
# the measured run
# --------------------------------------------------------------------------

def reckoned_bytes(cfg, shape: ShapeConfig, mesh, pcfg, ocfg) -> int:
    """What a run of ``cfg`` holds on the card at its peak, reckoned from
    shapes before anything is allocated: the state (every rank's block on the
    stacked mesh: the logical state), for a train step a gradient for each
    sync replica and one rank's, for a serving step the decode state; and the
    activations of a batch row, a residual stream a layer (block remat keeps
    each block's input) and twelve more, and the logits in fp32 three times
    (logits, softmax, gradient) over the TP ranks."""
    meta = StackedMesh(tuple(mesh.shape.values()), mesh.axis_names, "meta")
    setup = steps.make_setup(cfg, shape, meta, pcfg, ocfg)
    params = sum(t.numel() * t.element_size() for t in tree_flatten(setup.param_shapes)[0])
    b_axes = setup.ruleset.batch_axes(shape.global_batch) or ()
    rows = meta.size(b_axes)
    tp = meta.shape[setup.ruleset.tp] if steps._tp_axis(setup.ruleset) else 1
    tokens = shape.global_batch // rows * (shape.seq_len if shape.kind != "decode" else 1)
    act = tokens * (cfg.d_model * 2 * (cfg.num_layers + 12) + cfg.padded_vocab * 12 // tp)
    if shape.kind == "train":
        state = sum(t.numel() * t.element_size()
                    for t in tree_flatten(setup.state_shapes)[0])
        replicas = meta.size(tuple(a for a in setup.ruleset.dp))
        return state + (replicas + 1) * params + act
    cdt = steps.DTYPES[pcfg.compute_dtype]
    dstate = sum(t.numel() * t.element_size() for t in tree_flatten(
        tfm.init_decode_state(cfg, shape.global_batch, shape.seq_len, cdt, device="meta"))[0]
        if torch.is_tensor(t))
    return params + dstate + act


def _batch(cfg, shape: ShapeConfig, pcfg, seed: int, device):
    """The cell's inputs drawn from ``seed``: token ids uniform over the
    vocabulary, the modality stubs' embeddings 0.02 N(0, 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, t in steps.input_specs(cfg, shape, pcfg).items():
        if t.dtype in (torch.int32, torch.int64):
            a = rng.integers(0, cfg.vocab_size, tuple(t.shape)).astype(np.int32)
            out[k] = torch.from_numpy(a).to(device)
        else:
            a = rng.standard_normal(tuple(t.shape), dtype=np.float32) * 0.02
            out[k] = torch.from_numpy(a).to(device=device, dtype=t.dtype)
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _timed_s(call, device) -> float:
    """Seconds of one call: CUDA events on the card, the host clock on the
    CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        call()
        return time.perf_counter() - t0
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    call()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b) / 1e3


def measure_step(cfg, shape: ShapeConfig, mesh, pcfg, ocfg, *, timed: int = TIMED_STEPS,
                 by_op: bool = False) -> dict:
    """Build the cell's setup on ``mesh`` (every rank stacked on its device),
    draw parameters and inputs from ``SEED``, run one warm-up step, one
    counted step (``count_cost`` and ``count_collectives``, per device; each
    kernel's launches; with ``by_op`` the count by op) and ``timed`` timed
    steps.  Returns the run's record."""
    dev = mesh.device
    ranks = mesh.size(mesh.axis_names)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    setup = steps.make_setup(cfg, shape, mesh, pcfg, ocfg)
    params = tfm.init(SEED, cfg, dtype=steps.DTYPES[setup.pcfg.param_dtype], device=dev)
    placed = setup.init_state(params)
    del params
    batch = _batch(cfg, shape, setup.pcfg, SEED + 1, dev)
    box = [placed]
    if shape.kind == "train":
        def call():
            box[0], m = setup.step_fn(box[0], batch)
            return m
    elif shape.kind == "prefill":
        def call():
            return setup.step_fn(placed, batch)[0]
    else:
        state = steps.decode_state(setup, shape.seq_len - 1)

        def call():
            return setup.step_fn(placed, state, batch["tokens"])[0]
    _sync(dev)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = call()
    _sync(dev)
    t_first = time.perf_counter() - t0
    before = _launches()
    with count_cost(ranks, by_op) as cost, count_collectives() as colls:
        out = call()
        _sync(dev)
    launches = {k: v - before[k] for k, v in _launches().items()}
    times = [_timed_s(call, dev) for _ in range(timed)]
    if shape.kind == "train":
        check = {"loss": float(out["loss"])}
        finite = math.isfinite(check["loss"])
    else:
        check = {"logits_shape": list(out.shape)}
        finite = bool(torch.isfinite(out.float()).all())
    if not finite:
        raise FloatingPointError(f"{cfg.name} {shape.name}: the step's output is not "
                                 f"finite ({check})")
    peak = torch.cuda.max_memory_allocated(dev) / ranks if dev.type == "cuda" else None
    del setup, placed, box, batch, out
    if shape.kind == "decode":
        del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "encoder_layers": cfg.n_enc_layers or None,
            "cost": cost, "collectives": colls, "collective_bytes": colls["total_bytes"],
            "launches": launches,
            "seconds": {"setup": t_setup, "first_step": t_first,
                        "step": statistics.median(times)},
            "step_s": times, "peak_bytes_per_rank": peak, **check}


def probe_layer_cost(cfg, shape, mesh, pcfg, ocfg=None, *, timed: int = TIMED_STEPS) -> dict:
    """Run the step on an L=1 copy and an L=2 copy of the arch on the same
    mesh; per-layer cost = cost(L2) - cost(L1), base = L1 - layer
    (``corrected_totals``).  Each entry is ``measure_step``'s record."""
    pcfg = pcfg.replace(scan_layers=False)
    return {f"L{L}": measure_step(at_depth(cfg, L), shape, mesh, pcfg, ocfg, timed=timed)
            for L in (1, 2)}


def corrected_totals(rec, cfg) -> dict:
    """Trip-count-corrected FLOPs/bytes using the probe deltas."""
    p = rec.get("probe")
    if not p:
        return {}
    L = cfg.num_layers
    eff_layers = L // cfg.attn_every if cfg.family == "hybrid" else L
    l1, l2 = p["L1"], p["L2"]
    out = {}
    for key in ("flops", "bytes accessed"):
        per_layer = max(l2["cost"].get(key, 0) - l1["cost"].get(key, 0), 0)
        base = max(l1["cost"].get(key, 0) - per_layer, 0)
        out[key.replace(" ", "_")] = base + per_layer * eff_layers
    per_layer_coll = max(l2["collective_bytes"] - l1["collective_bytes"], 0)
    base_coll = max(l1["collective_bytes"] - per_layer_coll, 0)
    out["collective_bytes"] = base_coll + per_layer_coll * eff_layers
    return out


def autostrategy_block(cfg, shape: ShapeConfig, *, device=None):
    """``(decision, record)``: the FRED simulator's choice for the cell under
    the frozen defaults' optimizer and remat settings (its sweep on
    ``device``, ``cuda`` unless given), and the ``"autostrategy"`` block the
    dry run records for it, keyed as the JAX tool's."""
    from ..core.autostrategy import choose
    from ..core.specs import DeploymentRequest

    pcfg0, ocfg0 = paper_defaults(cfg, shape)
    d = choose(DeploymentRequest(
        model=cfg, shape=shape, master=ocfg0.master,
        moments_dtype=ocfg0.moments_dtype, remat=pcfg0.remat), device=device)
    rec = {
        "chosen": {"mp": d.mp, "dp": d.dp, "pp": d.pp,
                   "wafers": d.wafers, "fabric": d.fabric,
                   "wafer_shape": list(d.wafer_shape),
                   "inter_topology": d.inter_topology,
                   "hierarchy": list(d.hierarchy),
                   "execution": d.execution},
        "time_per_sample_s": d.time_per_sample_s,
        "memory_bytes_per_npu": d.memory_bytes_per_npu,
        "npu_hbm_bytes": d.npu_hbm_bytes,
        "why": {"n_candidates": d.n_candidates,
                "n_infeasible": d.n_infeasible,
                "n_dominated": d.n_dominated},
        "sweep_seconds": round(d.sweep_seconds, 3),
    }
    return d, rec


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             pcfg_overrides=None, probe: bool = True,
             autostrategy: bool = False, *, device="cuda") -> dict:
    """Place one cell on the production mesh and measure it on ``device``;
    return the roofline record.  The full depth runs where its reckoned bytes
    fit the card (on the CPU always).
    ``autostrategy=True`` lets the FRED simulator's sweep (on ``device``) pick
    the cell's strategy: recorded under ``"autostrategy"``
    (``autostrategy_block``) and stamped on the recorded ``pcfg`` as a
    ``StrategyDecision``.  ``pcfg_overrides`` win over the policy (the perf
    variants)."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = shape_applicability(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}

    mesh = _build_mesh(mesh_kind)
    dev = resolve_device(device)
    auto_rec = decision = None
    if autostrategy:
        decision, auto_rec = autostrategy_block(cfg, shape, device=dev)
    pcfg, ocfg = cell_policy(cfg, shape, mesh, autostrategy=autostrategy,
                             decision=decision)
    if pcfg_overrides:
        pcfg = pcfg.replace(**pcfg_overrides)

    t0 = time.time()
    placement = steps.make_setup(cfg, shape, mesh, pcfg, ocfg)
    t_place = time.time() - t0

    cmesh = card_mesh(mesh_kind, dev)
    cshape = card_shape(cfg, shape, cmesh, pcfg)
    need = reckoned_bytes(cfg, cshape, cmesh, pcfg, ocfg)
    budget = (int(MEMORY_SHARE * torch.cuda.get_device_properties(dev).total_memory)
              if dev.type == "cuda" else None)
    run_full = budget is None or need <= budget
    if not probe and not run_full:
        raise ValueError(f"{arch} {shape_name}: no probe and the full depth does not fit "
                         f"({need} reckoned bytes, {budget} to spend)")

    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok",
        "kind": shape.kind,
        "n_devices": cmesh.size(cmesh.axis_names),
        "n_devices_production": mesh.size(mesh.axis_names),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "memory_per_device": memory_per_device(placement),
        "reduced": {
            "mesh": dict(cmesh.shape), "production_mesh": dict(mesh.shape),
            "global_batch": cshape.global_batch, "of_global_batch": shape.global_batch,
            "seq_len": shape.seq_len,
            "depths": [1, 2] * probe + [cfg.num_layers] * run_full,
            "full_depth": run_full,
            "full_depth_reckoned_bytes": need, "card_bytes_to_spend": budget},
        "pcfg": dataclasses.asdict(pcfg),
    }
    if auto_rec is not None:
        rec["autostrategy"] = auto_rec
    del placement
    full = None
    if run_full:
        full = measure_step(cfg, cshape, cmesh, pcfg, ocfg)
        rec["full"] = full
    rec["cost_analysis"] = full["cost"] if full else None
    rec["collectives"] = full["collectives"] if full else None
    if probe:
        rec["probe"] = probe_layer_cost(cfg, cshape, cmesh, pcfg, ocfg)
        rec["corrected"] = corrected_totals(rec, cfg)
    deepest = full or rec["probe"]["L2"]
    rec["seconds"] = {"placement": t_place, **deepest["seconds"]}
    rec["peak_bytes_per_rank"] = deepest["peak_bytes_per_rank"]
    rec["roofline"] = roofline_terms(rec, cfg, cshape)
    return rec


def ep_compare(arch: str = "mixtral-8x7b", n_devices: int = 8,
               seq: int = 16, d_model: int = 64, d_ff: int = 128, *,
               device="cuda") -> dict:
    """Measure the expert-parallel all-to-all against the analytical model.

    Runs ``models.moe.moe_ffn_ep`` on a reduced copy of an MoE arch, every
    EP rank stacked on ``device`` (one sequence per EP rank, fp32), and
    counts its all-to-all bytes (``count_collectives``).  The bucket payload
    2·E·C·d (dispatch and combine, capacity headroom included) should match
    exactly; the cost model's token payload 2·T·k·d relates to it by the
    capacity factor.  Both ratios are recorded."""
    from ..models.moe import init_moe, moe_ffn_ep
    from ..parallel.sharding import shard_leaf

    base = get_config(arch)
    if not base.n_experts:
        raise ValueError(f"{arch} is not an MoE arch")
    cfg = dataclasses.replace(base, d_model=d_model, d_ff=d_ff, moe_dense_ff=0)
    dev = resolve_device(device)
    n = min(n_devices, cfg.n_experts)
    mesh = StackedMesh((n,), ("data",), dev)
    # drawn on the host from fixed seeds, then placed on the device
    params = {k: v.to(dev) for k, v in
              init_moe(torch.Generator().manual_seed(0), cfg, device="cpu").items()}
    placed = {"router": params["router"],
              **{k: shard_leaf(params[k], ("data", None, None), mesh)
                 for k in ("w_gate", "w_up", "w_down")}}
    x = torch.randn((n, seq, d_model), generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad(), count_collectives() as colls:
        out, aux = moe_ffn_ep(placed, shard_leaf(x, ("data",), mesh), cfg, mesh=mesh,
                              ep_axis="data")
        _sync(dev)
    measured = colls["per_kind_bytes"].get("all-to-all", 0)

    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    T_l = seq                                 # tokens per EP rank
    capacity = max(int(math.ceil(T_l * k * cf / E)), 4)
    capacity = -(-capacity // 4) * 4
    bucket_bytes = 2 * E * capacity * d_model * 4      # dispatch+combine, f32
    token_bytes = 2 * T_l * k * d_model * 4            # the cost-model payload
    return {
        "arch": arch, "n_devices": n, "seq": seq,
        "d_model": d_model, "d_ff": d_ff,
        "n_experts": E, "top_k": k, "capacity_factor": cf,
        "capacity": capacity,
        "measured_a2a_bytes_per_device": measured,
        "expected_bucket_bytes_per_device": bucket_bytes,
        "model_token_bytes_per_device": token_bytes,
        "measured_over_bucket": measured / bucket_bytes,
        "bucket_over_token": bucket_bytes / token_bytes,
        "per_kind_bytes": colls["per_kind_bytes"],
        "device": dev.type,
    }


def serving_compare(arch: str = "llama3.2-1b", *, prompt_tokens: int = 16,
                    output_tokens: int = 24, batch: int = 4,
                    d_model: int = 128, num_layers: int = 4,
                    vocab_size: int = 512, device="cuda") -> dict:
    """Measure per-token decode latency of the batched ``serve.engine.Engine``
    on a reduced copy of ``arch`` (head dim ``SERVING_HEAD_DIM``), every
    decode step's wall time but the first, beside the analytical
    prefill / decode / p50 / p99 that the serving objective quotes for the
    full arch on wafer hardware (``choose_serving_strategy``, priced on the
    host).  The record keeps both columns side by side and asserts no
    ratio: the card is not a wafer NPU."""
    from ..core.autostrategy import SERVE_OBJECTIVE, choose_serving_strategy
    from ..core.specs import Objective
    from ..serve.engine import Engine, EngineConfig, Request

    dev = resolve_device(device)
    base = get_config(arch)
    objective = Objective.serving(
        target_p99_ms=SERVE_OBJECTIVE.target_p99_ms,
        concurrent_users=SERVE_OBJECTIVE.concurrent_users,
        think_time_s=SERVE_OBJECTIVE.think_time_s,
        prompt_tokens=prompt_tokens, output_tokens=output_tokens)
    decision = choose_serving_strategy(base, objective)

    cfg = base.reduced(d_model=d_model, num_layers=num_layers,
                       vocab_size=vocab_size, head_dim=SERVING_HEAD_DIM)
    params = tfm.init(0, cfg, dtype=torch.float32, device=dev)
    ecfg = EngineConfig(max_batch=batch, cache_len=prompt_tokens + output_tokens,
                        target_p99_ms=objective.target_p99_ms,
                        arrival_rate_rps=(objective.concurrent_users /
                                          objective.think_time_s))
    engine = Engine(params, cfg, ecfg=ecfg, device=dev)
    reqs = [Request(uid=i, prompt=list(range(1, prompt_tokens + 1)),
                    max_new_tokens=output_tokens) for i in range(batch)]
    engine.run_batch(reqs)
    steps_s = engine.decode_step_s[1:]       # the first step warms up
    steps_sorted = sorted(steps_s)

    def _q(p):
        return steps_sorted[min(len(steps_sorted) - 1, int(p * len(steps_sorted)))]

    return {
        "arch": arch, "status": "ok",
        "reduced": {"d_model": d_model, "num_layers": num_layers,
                    "vocab_size": vocab_size, "batch": batch,
                    "prompt_tokens": prompt_tokens,
                    "output_tokens": output_tokens},
        "head_dim": SERVING_HEAD_DIM,
        "measured": {
            "backend": dev.type,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "n_decode_steps": len(steps_s),
            "decode_step_mean_s": sum(steps_s) / len(steps_s),
            "decode_step_p50_s": _q(0.50),
            "decode_step_p99_s": _q(0.99),
        },
        "analytical": {
            "placement": decision.placement,
            "wafers_per_cell": decision.wafers_per_cell,
            "total_wafers": decision.total_wafers,
            "prefill_s": decision.prefill_s,
            "decode_step_s": decision.decode_step_s,
            "ttft_p50_ms": decision.ttft_p50_ms,
            "ttft_p99_ms": decision.ttft_p99_ms,
            "target_p99_ms": decision.target_p99_ms,
        },
    }


def _write(path: Path, rec: dict) -> None:
    path.write_text(json.dumps(rec, indent=2, default=str))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--autostrategy", action="store_true",
                    help="let the FRED simulator's sweep (on the card) pick (mp, dp, "
                         "pp, wafers) per cell; records the decision and its "
                         "candidate, infeasible and dominated counts in the artifact")
    ap.add_argument("--serving", action="store_true",
                    help="run the batched serving engine on a reduced llama3.2-1b and "
                         "record the measured per-token decode latency; writes "
                         "<out>/serving_compare.json and exits")
    ap.add_argument("--ep-compare", action="store_true",
                    help="run the expert-parallel all-to-all on a reduced MoE arch and "
                         "diff its counted bytes against the analytical payload; writes "
                         "<out>/ep_compare.json and exits")
    ap.add_argument("--out", type=str, default="artifacts/dryrun")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("repro_torch.launch.dryrun: torch.cuda.is_available() is False; the dry "
              "run measures on an NVIDIA GPU", file=sys.stderr)
        return 2
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.serving:
        rec = serving_compare(args.arch or "llama3.2-1b")
        _write(outdir / "serving_compare.json", rec)
        m, a = rec["measured"], rec["analytical"]
        print(f"[dryrun] serving {rec['arch']}: measured decode "
              f"p50={m['decode_step_p50_s'] * 1e3:.2f}ms "
              f"p99={m['decode_step_p99_s'] * 1e3:.2f}ms ({m['device']}, reduced) | "
              f"analytical ({a['placement']}, {a['total_wafers']} wafers): "
              f"prefill={a['prefill_s'] * 1e3:.2f}ms "
              f"decode={a['decode_step_s'] * 1e3:.3f}ms "
              f"ttft_p99={a['ttft_p99_ms']:.1f}ms", flush=True)
        return 0

    if args.ep_compare:
        rec = ep_compare(args.arch or "mixtral-8x7b")
        _write(outdir / "ep_compare.json", rec)
        ok = abs(rec["measured_over_bucket"] - 1.0) < 0.01
        print(f"[dryrun] ep_compare {rec['arch']}: "
              f"measured/bucket={rec['measured_over_bucket']:.3f} "
              f"bucket/token={rec['bucket_over_token']:.3f} "
              f"{'OK' if ok else 'MISMATCH'}", flush=True)
        return 0 if ok else 1

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                name = f"{arch}__{shape}__{mk}"
                try:
                    rec = run_cell(arch, shape, mk, probe=not args.no_probe,
                                   autostrategy=args.autostrategy)
                except Exception as e:  # a failure here is a bug in the system
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mk,
                           "status": "error", "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                _write(outdir / f"{name}.json", rec)
                extra = ""
                if rec["status"] == "ok":
                    mb = rec["memory_per_device"]["total_bytes"] / 2**30
                    extra = (f" mem/dev>={mb:.2f}GiB step={rec['seconds']['step']:.4f}s "
                             f"depths={rec['reduced']['depths']}")
                    if "autostrategy" in rec:
                        c = rec["autostrategy"]["chosen"]
                        topo = f"+{c['inter_topology']}" if c["inter_topology"] else ""
                        extra += (f" auto=MP{c['mp']}-DP{c['dp']}-PP{c['pp']}-W{c['wafers']}"
                                  f"{topo}@{c['fabric']}/{c['execution']}")
                print(f"[dryrun] {name}: {rec['status']}{extra}", flush=True)
    if failures:
        print(f"[dryrun] {failures} FAILURES", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
