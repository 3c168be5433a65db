"""whisper-medium — encoder/decoder with conv frontend stubbed
[arXiv:2212.04356; unverified].

24L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=51865 (padded to 52096 for
16-way vocab TP).  24 encoder layers over precomputed frame embeddings
(enc_seq=1500), 24 decoder layers with cross-attention."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    n_enc_layers=24,
    enc_seq=1500,
    subquadratic=False,
)
