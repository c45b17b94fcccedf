"""RMSNorm on the card: the wrapper of ``csrc/rmsnorm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``:
``y = x * rsqrt(mean(x^2) + eps) * w`` over the last dimension, fp32 math,
stored in x's dtype, leading dimensions flattened into rows.

The arguments are checked as the kernel needs them on either device; then
a CUDA tensor launches the kernel (or raises) and a CPU tensor takes the
plain version, `rmsnorm_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm_ref import rmsnorm_ref

__all__ = ["rmsnorm"]


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    d = x.shape[-1]
    code = _build.dtype_code(x, "rmsnorm")
    if weight.dtype != x.dtype or weight.shape != (d,) or weight.device != x.device:
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} {weight.dtype} on "
                         f"{weight.device} does not match x (..., {d}) {x.dtype} on {x.device}")
    _build.check_layout("rmsnorm", x, weight)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, weight, eps=eps)
    lib = _build.library()
    x2 = x.reshape(-1, d)
    out = torch.empty_like(x2)
    with torch.cuda.device(x.device):
        err = lib.repro_rmsnorm(code, x2.data_ptr(), weight.data_ptr(), out.data_ptr(),
                                x2.shape[0], d, eps, _build.stream_of(x))
    _build.check(lib, err, "rmsnorm")
    _build.LAUNCHES["rmsnorm"] += 1
    return out.reshape(x.shape)
