"""Architecture registry: ``--arch <id>`` resolves here.

Only the architectures whose serving path the port runs are registered;
the others join with the slices that port their layers.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.qwen25_14b import CONFIG as QWEN25_14B

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (QWEN25_14B,)}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown --arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


__all__ = ["ARCHS", "ModelConfig", "get_config"]
