"""llava-next-34b — VLM decoder backbone, anyres tiling frontend stubbed
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  ``input_specs``
supplies precomputed patch embeddings (B, n_patches, d_model)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    n_patches=1024,
    subquadratic=False,
)
