"""mamba2-1.3b — attention-free SSD stack [arXiv:2405.21060; unverified].

48L d_model=2048 d_ff=0 vocab=50280 (padded), ssm_state=128."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    subquadratic=True,
)
