"""repro_torch.core — ABI-verified op substitution and the site runtime."""

from repro_torch.core.abi import AbiIncompatibility, AbiString, parse_abi, signature_digest
from repro_torch.core.bundle import Bundle, BundleError
from repro_torch.core.platform import LAPTOP, HardwareSpec, Platform, PlatformError
from repro_torch.core.registry import (
    ImplKind,
    OpBinding,
    OpDecl,
    OpImpl,
    OpRegistry,
    SwapReport,
    global_registry,
)
from repro_torch.core.runtime import Container, DeploymentError, Runtime

__all__ = [
    "AbiIncompatibility", "AbiString", "parse_abi", "signature_digest",
    "Bundle", "BundleError",
    "LAPTOP", "HardwareSpec", "Platform", "PlatformError",
    "ImplKind", "OpBinding", "OpDecl", "OpImpl", "OpRegistry", "SwapReport",
    "global_registry",
    "Container", "DeploymentError", "Runtime",
]
