"""qwen1.5-4b — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    subquadratic=False,
)
