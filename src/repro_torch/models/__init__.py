"""The port's model zoo: the dense text decoder (qwen2.5-14b's family)."""

from repro_torch.models.model import Model

__all__ = ["Model"]
