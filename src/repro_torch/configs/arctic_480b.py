"""arctic-480b — 128-expert top-2 MoE with parallel dense residual FFN
[hf:Snowflake/snowflake-arctic-base; hf].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 (per expert) vocab=32000,
MoE 128e top-2 + dense residual (d_ff=4864)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    moe_dense_ff=4864,
    subquadratic=False,
)
