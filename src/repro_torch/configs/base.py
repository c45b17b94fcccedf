"""`ModelConfig`: the architecture record a bundle carries.

A field-for-field copy of the JAX package's `ModelConfig`
(`repro/configs/base.py`), so a bundle's ``model_config`` dict means the
same thing on either runtime: ``to_dict`` of the two classes must stay
equal (tests/test_torch_core.py pins it).  `reduced()` gives the small
same-family variant the CPU tests run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # norm / activation
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    activation: str = "silu_glu"    # silu_glu | gelu
    # mixture of experts
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # expert hidden size (0 -> d_ff)
    n_shared_experts: int = 0
    moe_every: int = 1              # layer i hosts MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    # hybrid / state-space
    attn_every: int = 1             # hybrid: layer i is attention iff i % attn_every == 0
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # encoder-decoder (audio family)
    encoder_layers: int = 0
    # modality frontend stub: input_specs() provides precomputed embeddings
    modality: str = "text"          # text | vision | audio
    n_patches: int = 0              # vlm: patch embeddings prepended to tokens
    # numerics / training
    dtype: str = "bfloat16"
    remat: str = "full"             # none | dots | full
    tie_embeddings: bool = False
    # free-form provenance notes (source tags from the assignment)
    notes: str = ""

    # -- derived ------------------------------------------------------------
    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim if self.ssm_state else 0

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return i % self.attn_every == 0
        return True

    def is_moe_layer(self, i: int) -> bool:
        return self.num_experts > 0 and i % self.moe_every == self.moe_offset

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter counts — drives MODEL_FLOPS."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        active = emb
        n_layers = self.num_layers + self.encoder_layers
        for i in range(n_layers):
            dec_i = i - self.encoder_layers
            is_dec = dec_i >= 0
            li = dec_i if is_dec else i
            # attention (+ cross attention for decoder of enc-dec)
            if (not is_dec) or self.is_attn_layer(li):
                qkv = d * self.num_heads * self.head_dim + 2 * d * self.num_kv_heads * self.head_dim
                out = self.num_heads * self.head_dim * d
                att = qkv + out
                if is_dec and self.is_enc_dec:
                    att *= 2  # self + cross attention
                total += att
                active += att
            elif self.ssm_state:
                din = self.ssm_d_inner
                ssm = d * (2 * din + 2 * self.ssm_state + self.ssm_heads) + din * d
                total += ssm
                active += ssm
            # mlp / moe
            if self.d_ff or self.num_experts:
                if is_dec and self.is_moe_layer(li) and self.num_experts:
                    per_expert = 3 * d * self.expert_d_ff
                    total += self.num_experts * per_expert
                    active += (self.top_k + self.n_shared_experts) * per_expert
                elif self.d_ff:
                    per = d * self.d_ff * (3 if self.activation == "silu_glu" else 2)
                    total += per
                    active += per
        return total, active

    # -- smoke-test variant ----------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        hybrid = self.family == "hybrid"
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=4 if hybrid else 2,
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16 if self.head_dim else 0,
            d_ff=96 if self.d_ff else 0,
            vocab_size=256,
            num_experts=4 if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.num_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            attn_every=2 if hybrid else self.attn_every,
            n_patches=8 if self.n_patches else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=8 if self.ssm_state else 64,
            ssm_chunk=16,
            encoder_layers=2 if self.encoder_layers else 0,
            remat="none",
            dtype="float32",
        )

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ModelConfig":
        return cls(**d)
