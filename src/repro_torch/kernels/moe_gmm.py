"""Grouped expert matmul on the card: the wrapper of ``csrc/moe_gmm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/moe_gmm.py::moe_gmm``:
``y[i] = x[i] @ w[expert(i)]`` for rows of ``x`` (T, D) sorted by expert,
``group_sizes`` (E,) int32 partitioning them (sum == T), ``w`` (E, D, F);
fp32 accumulation, output in x's dtype, dropless at any T.

The library picks one of two kernels by x's dtype, T and E, and reports the
kernel each launch took; the wrapper counts it by (op, kernel) in
`_build.KERNEL_LAUNCHES` (names in `KERNELS`):

  * ``tensor_core`` — bf16 with at least E rows (prefill chunks, whole
    prompts): `mma.sync` bf16 products with fp32 sums over 128-row tiles
    of one expert, the weights streamed through a ring of copies in
    flight;
  * ``fma`` — fp32, and bf16 with fewer rows than experts (decode):
    fp32 FMAs.

The arguments are checked as the kernel needs them on either device
(rank, shapes, dtypes, one device, layout); then a CUDA tensor launches
the kernel (or raises) and a CPU tensor takes the dropless plain version,
`moe_gmm_exact`.  On the card nothing here reads ``group_sizes`` on the
host: the kernel finds its tiles from them on the device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_gmm_ref import moe_gmm_exact

__all__ = ["moe_gmm", "KERNELS"]

KERNELS = ("fma", "tensor_core")   # the library's kernel numbers, by name


def moe_gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"moe_gmm: x must be (T, D) and w (E, D, F), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    t, d = x.shape
    e, _, f = w.shape
    if w.shape[1] != d:
        raise ValueError(f"moe_gmm: w {tuple(w.shape)} does not contract x {tuple(x.shape)}")
    if group_sizes.dtype != torch.int32 or tuple(group_sizes.shape) != (e,):
        raise ValueError(f"moe_gmm: group_sizes must be ({e},) int32, got "
                         f"{tuple(group_sizes.shape)} {group_sizes.dtype}")
    code = _build.dtype_code(x, "moe_gmm")
    if w.dtype != x.dtype:
        raise ValueError(f"moe_gmm: w dtype {w.dtype} differs from x's {x.dtype}")
    if not (w.device == x.device == group_sizes.device):
        raise ValueError("moe_gmm: x, w and group_sizes must be on one device")
    _build.check_layout("moe_gmm", x, w)
    if not group_sizes.is_contiguous():
        raise ValueError("moe_gmm: group_sizes must be contiguous")
    if x.device.type == "cpu":
        return moe_gmm_exact(x, w, group_sizes)
    out = torch.empty((t, f), dtype=x.dtype, device=x.device)
    if t == 0 or f == 0:
        return out                                                  # nothing to launch
    lib = _build.library()
    took = ctypes.c_int(-1)
    with torch.cuda.device(x.device):
        err = lib.repro_moe_gmm(code, x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                                out.data_ptr(), t, d, f, e, _build.stream_of(x),
                                ctypes.byref(took))
    _build.check(lib, err, "moe_gmm")
    _build.LAUNCHES["moe_gmm"] += 1
    if took.value >= 0:
        _build.KERNEL_LAUNCHES["moe_gmm", KERNELS[took.value]] += 1
    return out
