"""Architecture registry: ``--arch <id>`` resolves here.

Only the architectures whose serving path the port runs are registered;
the others join with the slices that port their layers.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.mamba2_780m import CONFIG as MAMBA2_780M
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as MOONSHOT_V1_16B_A3B
from repro_torch.configs.phi35_moe_42b_a66b import CONFIG as PHI35_MOE_42B_A66B
from repro_torch.configs.qwen25_14b import CONFIG as QWEN25_14B

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (QWEN25_14B, MOONSHOT_V1_16B_A3B,
                                                     PHI35_MOE_42B_A66B, MAMBA2_780M)}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown --arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
