"""Plain PyTorch version of the quantized matmul op."""

from __future__ import annotations

import torch

__all__ = ["quant_matmul_ref"]


def quant_matmul_ref(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [T, D] float @ qw [D, F] int8/fp8, scale [F] fp32 per output
    channel -> [T, F] in x's dtype (fp32 math, like the kernel)."""
    w = qw.to(torch.float32) * scale.to(torch.float32)[None, :]
    return (x.to(torch.float32) @ w).to(x.dtype)
