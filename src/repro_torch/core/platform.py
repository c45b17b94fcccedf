"""Site platforms: the hardware a bundle is deployed onto.

Two sites exist for the port:

  * ``h100`` — one NVIDIA Hopper card (compute capability 9.0).  It has the
    native feature ``cuda_kernels``: the hand-written kernels under
    ``repro_torch/kernels/csrc`` are bound in place of the references.
  * ``laptop`` — the CPU.  No native features: every op keeps its plain
    PyTorch reference.

Detection is explicit.  The caller names the device; asking for CUDA on a
machine without a Hopper card is an error (`PlatformError`), never a quiet
move to the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["HardwareSpec", "Platform", "PlatformError", "LAPTOP", "CPU_HOST",
           "CUDA_KERNELS", "platform_for"]

# The native feature the CUDA kernels require (cf. "pallas_kernels").
CUDA_KERNELS = "cuda_kernels"
# Compute capability the kernels are built for (sm_90a).
HOPPER = (9, 0)


class PlatformError(RuntimeError):
    """The requested device does not exist or is not a supported card."""


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-device constants: what the card is and how much memory it has."""

    name: str
    hbm_bytes: int


@dataclasses.dataclass(frozen=True)
class Platform:
    """A deployable site: one device plus the native features it offers.

    `native_features` lists what the runtime may bind in place of the
    references — the analogue of the host's vendor MPI in the paper.
    """

    name: str
    hardware: HardwareSpec
    device: torch.device
    native_features: frozenset[str] = frozenset()
    description: str = ""

    def has(self, feature: str) -> bool:
        return feature in self.native_features


# Nominal host constants: a CPU "device" has no memory limit of its own.
CPU_HOST = HardwareSpec(name="cpu-host", hbm_bytes=0)

LAPTOP = Platform(
    name="laptop",
    hardware=CPU_HOST,
    device=torch.device("cpu"),
    native_features=frozenset(),
    description="CPU host; reference ops only (build/test)",
)


def _h100(index: int) -> Platform:
    if not torch.cuda.is_available():
        raise PlatformError("CUDA was requested but torch.cuda.is_available() is False")
    count = torch.cuda.device_count()
    if not 0 <= index < count:
        raise PlatformError(f"CUDA device {index} requested; {count} visible")
    cap = torch.cuda.get_device_capability(index)
    if cap != HOPPER:
        raise PlatformError(
            f"CUDA device {index} has compute capability {cap}; the kernels "
            f"are built for sm_90a and need {HOPPER}")
    props = torch.cuda.get_device_properties(index)
    return Platform(
        name="h100",
        hardware=HardwareSpec(name=props.name, hbm_bytes=int(props.total_memory)),
        device=torch.device("cuda", index),
        native_features=frozenset({CUDA_KERNELS}),
        description="one NVIDIA Hopper card; hand-written CUDA kernels",
    )


def platform_for(device: str | torch.device, cuda_index: int = 0) -> Platform:
    """The platform for an explicitly requested device.

    ``device`` is ``"cpu"`` or ``"cuda"`` (``"cuda:N"`` names the index
    itself; a bare ``"cuda"`` takes ``cuda_index``).  Raises `PlatformError`
    when CUDA is asked for and no Hopper card answers at that index.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return LAPTOP
    if dev.type != "cuda":
        raise PlatformError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return _h100(cuda_index if dev.index is None else dev.index)
