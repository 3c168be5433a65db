"""qwen3-32b — qk-norm + GQA [hf:Qwen/Qwen3-8B; hf].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    subquadratic=False,
)
