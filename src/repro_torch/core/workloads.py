"""Paper workloads (Table V) characterized at layer level.

The PyTorch port's own copy of ``repro.core.workloads``: the same code (the port
imports nothing of the JAX package); ``tests/test_torch_core.py`` holds its
results equal to the original's.

All four workloads are modeled from first principles (params, FLOPs,
activation sizes) with the paper's settings: FP16 everywhere, minibatch =
DP_size × 16 samples, Megatron-style MP sync (2 All-Reduces per layer per
pass), GPipe microbatching for PP, weight-stationary vs weight-streaming
execution (Sec. III-A).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple, TYPE_CHECKING

from .placement import Strategy

if TYPE_CHECKING:                      # core stays jax-free at runtime
    from repro_torch.models.config import ModelConfig, ShapeConfig

BYTES = 2  # FP16


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    n_layers: int
    params_per_layer: float        # bytes are params × BYTES
    flops_fwd_per_sample_layer: float
    act_bytes_per_sample: float    # boundary activation per sample
    strategy: Strategy
    execution: str                 # "stationary" | "streaming"
    mp_allreduce_per_layer: int = 2   # Megatron fwd (and again in bwd)
    samples_per_dp: int = 16
    seq: int = 1
    # serving-only KV-cache footprint (2·d_kv·BYTES for attention models,
    # 0 for training workloads where the cache is part of the activations)
    kv_bytes_per_sample_layer: float = 0.0
    # fraction of params_per_layer actually multiplied per sample (MoE
    # top-k routing; 1.0 for dense).  flops_fwd_per_sample_layer already
    # accounts for it — this field only documents the ratio.
    active_param_fraction: float = 1.0
    # expert-dispatch All-to-All payload per sample per MoE layer
    # (top_k · d_model · BYTES: each token ships top-k d-vectors to its
    # experts); 0 for dense models — gates the simulator's EP phase.
    a2a_bytes_per_sample_layer: float = 0.0
    # fraction of params_per_layer that are expert FFN weights — the part
    # expert parallelism shards over Strategy.ep (0 for dense models)
    expert_param_fraction: float = 0.0

    @property
    def params_total(self) -> float:
        return self.params_per_layer * self.n_layers

    @property
    def param_bytes_total(self) -> float:
        return self.params_total * BYTES

    @property
    def minibatch(self) -> int:
        return self.strategy.dp * self.samples_per_dp


def transformer(name: str, n_layers: int, d_model: int, seq: int,
                strategy: Strategy, execution: str,
                samples_per_dp: int = 16,
                token_samples: bool = True) -> Workload:
    """LM workload.  The paper sets minibatch = DP_size×16 *samples* but
    does not define a transformer sample.  Two readings:

    * ``token_samples=True``  — a sample is one token.  This is the only
      reading under which all four Fig. 10 speedups are jointly
      reachable (compute small ⇒ latency-bound mesh collectives and
      critical-path weight streaming; see EXPERIMENTS.md §Fig10).
      Used for the calibrated headline reproduction.
    * ``token_samples=False`` — a sample is a seq-length sequence.  This
      is the reading under which Fig. 2's 'MP(20) communication dominates'
      sweep holds (activation all-reduces are then param-scale).  Used by
      benchmarks/fig2_strategies.py.

    Both are reported; the ambiguity is documented, not hidden."""
    params_layer = 12 * d_model * d_model          # qkvo + 4d ff
    if token_samples:
        flops_fwd = 2 * params_layer               # per token
        act = d_model * BYTES
    else:
        flops_fwd = 2 * params_layer * seq + 4 * seq * seq * d_model
        act = seq * d_model * BYTES
    return Workload(name=name, n_layers=n_layers,
                    params_per_layer=params_layer,
                    flops_fwd_per_sample_layer=flops_fwd,
                    act_bytes_per_sample=act,
                    strategy=strategy, execution=execution,
                    samples_per_dp=samples_per_dp, seq=seq)


def resnet152(strategy: Strategy) -> Workload:
    total_params = 60.2e6
    total_fwd_flops = 11.5e9          # @224² per sample
    n_layers = 152
    return Workload(name="ResNet-152", n_layers=n_layers,
                    params_per_layer=total_params / n_layers,
                    flops_fwd_per_sample_layer=total_fwd_flops / n_layers,
                    act_bytes_per_sample=7 * 7 * 2048 * BYTES,
                    strategy=strategy, execution="stationary",
                    mp_allreduce_per_layer=0)


def paper_workloads() -> List[Workload]:
    """Table V exactly."""
    return [
        resnet152(Strategy(1, 20, 1)),
        # Turing-NLG 17B: 78 layers, d=4256, seq 1024
        transformer("Transformer-17B", 78, 4256, 1024,
                    Strategy(3, 3, 2), "stationary"),
        # GPT-3 175B: 96 layers, d=12288, seq 2048
        transformer("GPT-3", 96, 12288, 2048,
                    Strategy(2, 5, 2), "streaming"),
        # Transformer-1T: 128 layers, d=25600, seq 2048
        transformer("Transformer-1T", 128, 25600, 2048,
                    Strategy(1, 20, 1), "streaming"),
    ]


# --------------------------------------------------------------------------
# per-NPU memory-feasibility model (richer sweep objectives)
# --------------------------------------------------------------------------

# The cost model's default HBM budget of one simulated NPU (the JAX package's
# value, kept so the two packages give the same results): an input of the
# modelled wafer, not the memory of the card this code runs on.
DEFAULT_NPU_HBM_BYTES = 16 * 2**30

# Activation multiplier vs the layer-boundary tensor, per remat setting.
# First-order: "full" keeps one boundary tensor per layer for backward;
# "block" additionally saves the projection outputs (~4× boundary);
# "none" keeps every intermediate (qkv + scores + ffn hidden ≈ 12×
# boundary for a 4×-FFN transformer).
ACT_REMAT_MULT = {"full": 1.0, "block": 4.0, "none": 12.0}


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Per-NPU memory settings the feasibility predicate evaluates under.

    ``master`` / ``moments_dtype`` mirror ``repro_torch.train.optim.OptimConfig``
    (fp32 master copy; fp32/bf16/int8 Adam moments); ``remat`` mirrors
    ``ParallelConfig.remat``.  ``training=False`` drops gradients and
    optimizer state and adds the KV cache instead (serving cells).
    """
    npu_hbm_bytes: float = DEFAULT_NPU_HBM_BYTES
    master: bool = True
    moments_dtype: str = "float32"   # float32 | bfloat16 | int8
    remat: str = "full"              # none | block | full
    training: bool = True


def optimizer_bytes_per_param(master: bool, moments_dtype: str) -> float:
    """Optimizer-state bytes per parameter (excl. the param + grad).

    fp32 master (optional, 4 B) + two Adam moments at ``moments_dtype``
    (int8 carries a per-row fp32 scale — amortized below 1.1 B/param for
    any row ≥ 16 wide, folded into the 1-byte figure)."""
    moment = {"float32": 4.0, "bfloat16": 2.0, "int8": 1.0}[moments_dtype]
    return (4.0 if master else 0.0) + 2 * moment


def memory_bytes_per_npu(w: Workload, mem: MemoryModel) -> float:
    """Peak per-NPU bytes for ``w`` under its own strategy and ``mem``.

    Sharding model (matches the simulator's placement): MP shards within a
    layer, PP shards layers (largest stage = ceil(n_layers/pp) paces the
    pipeline *and* holds the most state), DP replicates.  Sequence
    parallelism (``Strategy.sp``) shards activations a further ``sp``-way;
    expert parallelism (``Strategy.ep``) shards the expert share of the
    params over the EP group.  Weight-streaming
    keeps only a double-buffered layer (+ a gradient buffer when
    training) resident — the optimizer runs near storage (Sec. III-A).

    Monotone by construction: nondecreasing in params_per_layer,
    n_layers, act_bytes_per_sample and seq at a fixed strategy — the
    property the hypothesis tests in tests/test_autostrategy.py pin.
    """
    st = w.strategy
    layers_per_stage = -(-w.n_layers // st.pp)
    # expert weights shard over the EP group: the (1−f) dense share stays
    # replicated per MP shard, the f expert share divides by ep
    ep_share = 1.0
    if st.ep > 1 and w.expert_param_fraction:
        f = w.expert_param_fraction
        ep_share = (1.0 - f) + f / st.ep
    if w.execution == "streaming":
        buffers = 3 if mem.training else 2      # 2 stream + 1 grad out
        resident_params = buffers * w.params_per_layer * ep_share / st.mp
        opt_bytes = 0.0                          # optimizer near storage
        grad_bytes = 0.0                         # counted in the buffers
    else:
        resident_params = (w.params_per_layer * ep_share *
                           layers_per_stage / st.mp)
        opt_bytes = (resident_params *
                     optimizer_bytes_per_param(mem.master, mem.moments_dtype)
                     if mem.training else 0.0)
        grad_bytes = resident_params * BYTES if mem.training else 0.0
    weight_bytes = resident_params * BYTES

    # activation working set: one microbatch of `seq` samples per replica
    # (gradient accumulation bounds it regardless of samples_per_dp),
    # boundary tensor per layer of the stage, remat-scaled, SP-sharded
    mult = ACT_REMAT_MULT[mem.remat] if mem.training else 1.0
    act_layers = layers_per_stage if mem.training else 1
    act_bytes = (mult * act_layers * w.act_bytes_per_sample *
                 max(w.seq, 1) / st.mp / st.sp)

    kv_bytes = 0.0
    if not mem.training and w.kv_bytes_per_sample_layer:
        # full cache: every past sample of the replica's batch, all layers
        kv_bytes = (w.kv_bytes_per_sample_layer * w.samples_per_dp *
                    layers_per_stage / st.mp)
    return weight_bytes + grad_bytes + opt_bytes + act_bytes + kv_bytes


def is_feasible(w: Workload, mem: MemoryModel) -> bool:
    """The memory-feasibility predicate: fits the per-NPU HBM budget.

    Monotone in the budget (more HBM never removes a feasible strategy)
    and antitone in model size (a larger model never adds one)."""
    return memory_bytes_per_npu(w, mem) <= mem.npu_hbm_bytes


# --------------------------------------------------------------------------
# ModelConfig → Workload adapter (sweep-driven auto-strategy)
# --------------------------------------------------------------------------

def _layer_param_counts(cfg: "ModelConfig") -> Tuple[float, float]:
    """(resident, active) params per layer for a registry architecture.

    First-order per-family accounting; embeddings/LM head are spread
    across layers so ``params_total`` covers the whole model.  MoE keeps
    every expert resident but multiplies only top-k per sample.
    """
    d = cfg.d_model
    attn = (d * cfg.d_qkv + 2 * d * cfg.d_kv + cfg.d_qkv * d
            if cfg.n_heads else 0.0)
    ffn_gated = 3 * d * cfg.d_ff                 # SwiGLU (llama/qwen style)
    if cfg.family == "moe":
        router = d * cfg.n_experts
        experts = cfg.n_experts * ffn_gated
        dense_branch = 3 * d * cfg.moe_dense_ff if cfg.moe_dense_ff else 0.0
        resident = attn + router + experts + dense_branch
        active = attn + router + cfg.top_k * ffn_gated + dense_branch
    elif cfg.family == "ssm":
        resident = active = _ssm_block_params(cfg)
    elif cfg.family == "hybrid":
        # Mamba2 stack + ONE shared attention block (zamba2), amortized
        shared = attn + ffn_gated if cfg.d_ff else attn
        resident = active = (_ssm_block_params(cfg) +
                             shared / max(cfg.num_layers, 1))
    elif cfg.family == "audio":
        # encoder: self-attn + 2-matrix GELU MLP; decoder adds cross-attn.
        # Averaged over (enc + dec) layers — Workload.n_layers is the sum.
        mlp = 2 * d * cfg.d_ff
        enc = cfg.n_enc_layers * (attn + mlp)
        dec = cfg.num_layers * (2 * attn + mlp)
        resident = active = (enc + dec) / max(cfg.num_layers +
                                              cfg.n_enc_layers, 1)
    else:                                        # dense | vlm
        resident = active = attn + ffn_gated
    n_layers = adapter_n_layers(cfg)
    emb = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    return resident + emb / n_layers, active + emb / n_layers


def _ssm_block_params(cfg: "ModelConfig") -> float:
    """Mamba2/SSD block: in-proj (x, z, B, C, dt heads), depthwise conv,
    out-proj, per-head A/D/dt-bias (first-order)."""
    d, di = cfg.d_model, cfg.d_inner
    bc = 2 * cfg.ssm_groups * cfg.ssm_state
    in_proj = d * (2 * di + bc + cfg.ssm_heads)
    conv = cfg.ssm_conv * (di + bc)
    out_proj = di * d
    return in_proj + conv + out_proj + 3 * cfg.ssm_heads


def adapter_n_layers(cfg: "ModelConfig") -> int:
    """Layer count as the Workload sees it (audio: enc + dec)."""
    return max(cfg.num_layers + cfg.n_enc_layers, 1)


def from_model_config(cfg: "ModelConfig", shape: "ShapeConfig",
                      strategy: Strategy,
                      execution: str = "stationary") -> Workload:
    """Derive the analytical Workload for a registry (arch × shape) cell.

    A sample is one token (the calibrated Fig. 10 reading); a microbatch
    is one ``seq_len``-token sequence.  ``samples_per_dp`` carries the
    cell's *whole* per-replica token budget (global_batch · seq_len / dp)
    so ``minibatch`` ≈ the fixed global token count and ``time_per_sample``
    compares strategies at equal work.  MP all-reduces follow Megatron
    (2/layer each pass) for families with intra-layer sharded matmuls —
    which is every family here; SSM scans sync B/C projections the same
    way, so the count is kept uniform.
    """
    resident, active = _layer_param_counts(cfg)
    n_layers = adapter_n_layers(cfg)
    d = cfg.d_model
    # per-token forward FLOPs: 2·active params + causal attention
    # quadratic term (averaged position ⇒ seq/2 keys, 2 matmuls ⇒ 2·seq)
    seq_eff = shape.seq_len
    if cfg.sliding_window:
        seq_eff = min(seq_eff, cfg.sliding_window)
    quad = 2 * seq_eff * cfg.d_qkv if cfg.n_heads else 0.0
    if cfg.family == "hybrid":
        quad = quad / max(cfg.attn_every, 1)     # shared block cadence
    flops_fwd = 2 * active + quad
    total_samples = shape.global_batch * shape.seq_len
    samples_per_dp = max(1, total_samples // strategy.dp)
    serving = shape.kind != "train"
    kv = 2 * cfg.d_kv * BYTES if (serving and cfg.n_heads) else 0.0
    moe = cfg.family == "moe"
    # each token ships top-k d-vectors to its experts (dispatch; combine
    # is charged separately by the simulator's ×2)
    a2a = cfg.top_k * d * BYTES if moe else 0.0
    expert_frac = ((cfg.n_experts * 3 * d * cfg.d_ff) / resident
                   if moe and resident else 0.0)
    return Workload(
        name=f"{cfg.name}:{shape.name}",
        n_layers=n_layers,
        params_per_layer=resident,
        flops_fwd_per_sample_layer=flops_fwd,
        act_bytes_per_sample=d * BYTES,
        strategy=strategy,
        execution=execution,
        mp_allreduce_per_layer=2,
        samples_per_dp=samples_per_dp,
        seq=shape.seq_len,
        kv_bytes_per_sample_layer=kv,
        active_param_fraction=active / resident if resident else 1.0,
        a2a_bytes_per_sample_layer=a2a,
        expert_param_fraction=expert_frac,
    )


def fig2_strategies() -> List[Strategy]:
    """The Transformer-17B parallelization sweep of Fig. 2."""
    return [
        Strategy(20, 1, 1),
        Strategy(10, 2, 1),
        Strategy(5, 4, 1),
        Strategy(4, 5, 1),
        Strategy(2, 10, 1),
        Strategy(1, 20, 1),
        Strategy(5, 2, 2),
        Strategy(2, 5, 2),
        Strategy(10, 1, 2),
        Strategy(4, 1, 5),
    ]
