"""Model / parallelism configuration dataclasses (the PyTorch port's own copy).

This file mirrors ``repro.models.config`` field for field so that a
configuration means the same thing in both packages; the port keeps its own
copy because it imports nothing of the JAX package.

Every assigned architecture (and the paper's own workloads) is described by a
:class:`ModelConfig`.  The config is a *complete* architectural description:
the model code in ``repro_torch.models`` consumes nothing else.

``ParallelConfig`` holds the distribution policy knobs that the runtime
(``repro.parallel`` in the JAX package; not ported yet) uses to derive
parameter/activation shardings for a given mesh.  The FRED-inspired collective schedule is selected here as well
(``grad_sync``), so that the paper-faithful baseline ("flat" endpoint-style
ring all-reduce) and the FRED-style hierarchical schedule can be compared
like-for-like on the same model.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (family-polymorphic).

    Families:
      * ``dense``  — standard decoder-only transformer (llama/qwen/chatglm).
      * ``moe``    — mixture-of-experts FFN (mixtral/arctic).
      * ``ssm``    — attention-free Mamba2 / SSD stack.
      * ``hybrid`` — Mamba2 blocks + a *shared* attention block (zamba2).
      * ``vlm``    — decoder LM consuming precomputed patch embeddings
                     (llava; frontend is a stub per the task spec).
      * ``audio``  — encoder/decoder transformer consuming precomputed
                     audio frame embeddings (whisper; conv frontend stub).
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio

    num_layers: int
    d_model: int
    n_heads: int          # query heads (0 for attention-free)
    n_kv_heads: int       # KV heads (GQA); == n_heads for MHA
    d_ff: int             # FFN hidden size (0 for attention-free SSM stack)
    vocab_size: int

    head_dim: int = 128

    # --- attention variants -------------------------------------------------
    rope: str = "default"            # default | 2d (chatglm) | none
    rope_theta: float = 10000.0
    qk_norm: bool = False            # qwen3-style RMS norm on q/k heads
    qkv_bias: bool = False           # qwen1.5-style bias on QKV projections
    sliding_window: int = 0          # >0: SWA window (mixtral)
    causal: bool = True

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_dense_ff: int = 0            # arctic: parallel dense-residual FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance auxiliary loss

    # --- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0               # d_state (N)
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1              # B/C projection groups
    attn_every: int = 0              # hybrid: shared attn block period

    # --- encoder/decoder (audio) ----------------------------------------------
    n_enc_layers: int = 0
    enc_seq: int = 0                 # precomputed frame count (whisper: 1500)

    # --- VLM -----------------------------------------------------------------
    n_patches: int = 0               # precomputed patch embeddings (llava)

    # --- embeddings / misc ----------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    vocab_pad_to: int = 256          # pad vocab for TP divisibility

    # --- attention applicability metadata -------------------------------------
    subquadratic: bool = False       # may run long_500k decode

    # -------------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        v, m = self.vocab_size, self.vocab_pad_to
        return ((v + m - 1) // m) * m

    @property
    def d_qkv(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            num_layers=min(self.num_layers, 2 if not self.attn_every else 4),
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            moe_dense_ff=64 if self.moe_dense_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            attn_every=2 if self.attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=16 if self.enc_seq else 0,
            n_patches=8 if self.n_patches else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            vocab_pad_to=32,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One cell of the (architecture × input-shape) grid."""

    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_serving(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class StrategyDecision:
    """The sweep-chosen parallelization for a cell (core/autostrategy.py).

    Replaces the legacy positional 5-tuple ``(mp, dp, pp, wafers,
    inter_topology)`` with named fields, while staying *tuple-compatible*:
    iteration, ``len``, indexing, unpacking, and equality against a plain
    tuple all see exactly those five legacy fields.  New axes ride along
    without widening the tuple protocol: ``ep``/``sp`` reserve the
    expert- and sequence-parallel degrees, and ``defect_seed`` records
    the ``core.defects.sample_mask`` seed when the decision was
    made under a defect mask (None = pristine wafer).
    """

    mp: int = 0
    dp: int = 0
    pp: int = 0
    wafers: int = 0
    inter_topology: str = ""      # ring | fully_connected | switch; ""
                                  # for single-wafer decisions
    ep: int = 1                   # expert-parallel degree (reserved)
    sp: int = 1                   # sequence-parallel degree (reserved)
    defect_seed: Optional[int] = None

    @property
    def is_set(self) -> bool:
        """False for the all-zero sentinel (sweep not run)."""
        return self._legacy() != (0, 0, 0, 0, "")

    def _legacy(self) -> tuple:
        return (self.mp, self.dp, self.pp, self.wafers,
                self.inter_topology)

    # -- legacy tuple protocol ----------------------------------------------
    def __iter__(self):
        return iter(self._legacy())

    def __len__(self) -> int:
        return 5

    def __getitem__(self, i):
        return self._legacy()[i]

    def __eq__(self, other):
        if isinstance(other, StrategyDecision):
            return dataclasses.astuple(self) == dataclasses.astuple(other)
        if isinstance(other, tuple):
            return self._legacy() == other
        return NotImplemented

    def __hash__(self):
        return hash(self._legacy())

    @classmethod
    def coerce(cls, value) -> "StrategyDecision":
        """Adapt a legacy positional tuple (or pass a decision through)."""
        if isinstance(value, cls):
            return value
        return cls(*value)


@dataclass(frozen=True)
class ParallelConfig:
    """Distribution policy for a given mesh.

    ``grad_sync`` selects the data-parallel gradient synchronization
    schedule — this is where the FRED technique surfaces in the runtime:

      * ``flat``       — single ring all-reduce across all data-parallel
                         replicas (the endpoint-based collective the paper's
                         2D-mesh baseline is limited to).
      * ``hierarchical`` — FRED-style reduction tree: reduce-scatter inside
                         the pod (the L1 switch reduction), all-reduce across
                         pods on the scattered shard (the L2 reduction), then
                         all-gather inside the pod (the distribution tree).
      * ``compressed`` — hierarchical + int8 quantization with error feedback
                         on the cross-pod phase (software analogue of FRED's
                         in-network traffic halving; beyond-paper).
    """

    mesh_axes: Tuple[str, ...] = ("data", "model")
    dp_axes: Tuple[str, ...] = ("data",)          # batch-sharded axes
    tp_axis: str = "model"
    param_sharding: str = "fsdp"                  # replicated | zero1 | fsdp
    attn_sharding: str = "heads"                  # heads | context
    scan_layers: bool = True
    remat: str = "block"                          # none | block | full
    grad_sync: str = "hierarchical"               # flat | hierarchical | compressed
    seq_shard: bool = True                        # SP: shard seq dim of activations
    moe_ep_axis: str = ""                         # "" = TP-only MoE
    compute_dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"
    attn_q_chunk: int = 1024
    attn_k_chunk: int = 1024
    use_pallas: bool = False                      # kept for field parity; the port
                                                  # dispatches in kernels/ops.py
    # sweep-driven auto-strategy (core/autostrategy.py): the simulator-
    # chosen StrategyDecision for this cell.  The default (all-zero)
    # decision means hand-set defaults / sweep not run.  Tuple-compatible
    # with the legacy (mp, dp, pp, wafers, inter_topology) 5-tuple —
    # a plain tuple assigned here still unpacks and compares the same.
    # Informational for the runtime mesh (the launcher builds the mesh),
    # executable for the wafer-side placement.
    auto_strategy: StrategyDecision = StrategyDecision()

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)
