"""Shared quantization numerics: int8 / fp8 formats, one set of rules.

A copy of `repro/kernels/quant.py` on torch tensors: the same formats,
constants and rounding, so the codes and scales are bit for bit the JAX
package's (tests/test_torch_quant.py holds them equal).

  * ``int8`` — symmetric linear: ``scale = amax / 127``, values rounded
    half to even and clipped to [-127, 127] (-128 is never produced).
  * ``fp8`` — ``torch.float8_e4m3fn``: ``scale = amax / 448`` (the e4m3fn
    max-normal), values clipped to +-448, then cast to the fp8 grid.

Scales are float32 and strictly positive (the ``EPS`` floor).  The scale
is computed in the input's dtype and only then cast to float32, as JAX
does (its constants are weakly typed): for a bf16 input, ``amax / 127``
is rounded to bf16 first.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["EPS", "FORMATS", "FP8_DTYPE", "FP8_MAX", "INT8_MAX", "RAW_BITS", "STORAGE_DTYPES",
           "dequantize", "format_of", "quantize", "quantize_per_channel", "storage_dtype",
           "to_codes"]

INT8_MAX = 127.0
# max normal of float8_e4m3fn (S.1110.111 = 448)
FP8_MAX = 448.0
# amax floor: keeps every scale strictly positive
EPS = 1e-12

FORMATS = ("int8", "fp8")

FP8_DTYPE = torch.float8_e4m3fn

# each format's storage dtype (1 byte an element)
STORAGE_DTYPES = {"int8": torch.int8, "fp8": FP8_DTYPE}

# dtypes numpy has only through ml_dtypes (the JAX package's arrays, a
# checkpoint's dtype strings): read as raw bits of that width, then viewed
# as the torch dtype
RAW_BITS = {"bfloat16": (np.uint16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, FP8_DTYPE)}


def storage_dtype(fmt: str) -> torch.dtype:
    """The storage dtype of a format (1 byte each)."""
    if fmt not in STORAGE_DTYPES:
        raise ValueError(f"unknown quantization format {fmt!r}")
    return STORAGE_DTYPES[fmt]


def format_of(dtype: torch.dtype) -> str:
    """The format whose codes are stored as `dtype`."""
    for fmt, dt in STORAGE_DTYPES.items():
        if dt == dtype:
            return fmt
    raise ValueError(f"{dtype} is not a quantization storage dtype")


def _scale_from_amax(amax: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt not in FORMATS:
        raise ValueError(f"unknown quantization format {fmt!r}")
    top = INT8_MAX if fmt == "int8" else FP8_MAX
    # in amax's dtype, then float32 (not float32 first: see the module note)
    return (torch.clamp_min(amax, EPS) / top).to(torch.float32)


def to_codes(y: torch.Tensor, fmt: str) -> torch.Tensor:
    """Scaled float32 values `y` onto the format's grid: int8 rounds half
    to even and clips to +-127, fp8 clips to +-448 and casts."""
    if fmt == "int8":
        return torch.clamp(torch.round(y), -INT8_MAX, INT8_MAX).to(torch.int8)
    return torch.clamp(y, -FP8_MAX, FP8_MAX).to(FP8_DTYPE)


def quantize(x: torch.Tensor, fmt: str = "int8", scale=None):
    """Whole-tensor quantization: ``(q, scale)`` with a single scalar
    scale (derived from amax unless a calibrated one is passed)."""
    if scale is None:
        scale = _scale_from_amax(x.abs().amax(), fmt)
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return to_codes(x.to(torch.float32) / scale, fmt), scale


def quantize_per_channel(x: torch.Tensor, axis: int = -1, fmt: str = "int8"):
    """Per-channel quantization along ``axis``: ``(q, scale)`` where
    ``scale`` has ``x``'s shape with ``axis`` removed."""
    scale = _scale_from_amax(x.abs().amax(dim=axis, keepdim=True), fmt)
    return to_codes(x.to(torch.float32) / scale, fmt), scale.squeeze(axis)


def dequantize(q: torch.Tensor, scale, axis: int = -1,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Invert quantize/quantize_per_channel.  ``scale`` may be a scalar
    (whole-tensor) or a per-channel vector matched to ``axis``."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    if scale.dim() and q.dim() > scale.dim():
        scale = scale.unsqueeze(axis)
    return (q.to(torch.float32) * scale).to(dtype)
