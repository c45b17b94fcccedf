"""moonshot-v1-16b-a3b — Moonlight-16B-A3B (kimi/moonshot).

48L d_model=2048 16H (GQA kv=16 -> effectively MHA) d_ff=1408(expert)
vocab=163840, MoE 64 experts top-6, 2 shared experts.
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=163_840,
    num_experts=64,
    top_k=6,
    n_shared_experts=2,
    rope_theta=5e4,
    notes="[hf:moonshotai/Moonlight-16B-A3B; hf] 64e top-6 + 2 shared experts",
)
