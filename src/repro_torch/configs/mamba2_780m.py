"""mamba2-780m — Mamba-2 780M, SSD (state-space duality, arXiv:2405.21060).

48L d_model=1536, attention-free, vocab=50280, ssm_state=128,
expand=2 (d_inner=3072), headdim=64 -> 48 SSD heads.
[arXiv:2405.21060; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    tie_embeddings=True,
    notes="[arXiv:2405.21060; unverified] SSD (state-space duality)",
)
