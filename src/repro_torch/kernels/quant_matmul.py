"""Quantized matmul on the card: the wrapper of ``csrc/quant_matmul.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/quant_matmul.py::quant_matmul``:
``y = (x @ qw) * scale[None, :]`` for x (T, D) float32 or bfloat16, qw
(D, F) int8 or float8_e4m3fn codes and one float32 scale an output
channel (the checkpoint's per-channel layout); fp32 sums, y in x's dtype.

The library picks one of three kernels by x's dtype and T:

  * bf16 x, T > 4 (prefill chunks, whole prompts): bf16 tensor cores
    (wgmma) on 128-row tiles, the codes copied as 1 byte and decoded to
    bf16 in shared memory.  Every int8 code and every finite e4m3 value is
    exact in bf16, and a product of two bf16 values is exact in fp32, so
    the result is the fp32 product up to the order of the sums.  Its
    products and its decoding share the SM's shared memory, which bounds
    it (a 128-token chunk about as fast as ``torch.matmul`` on the dense
    bf16 weight).
  * fp32 x, T > 4: fp32 FMAs on 32-row tiles; TF32 tensor cores would
    round x past fp32's tolerance.
  * T <= 4 (decode ticks, one token's LM head): the codes streamed into
    registers and multiplied with FMAs; bound by reading the codes, which
    a tensor-core tile of 64 rows would not read faster.

The arguments are checked as the kernel needs them on either device;
then a CUDA tensor launches the kernel (or raises) and a CPU tensor takes
the plain version, `quant_matmul_ref`.  Where the grid would leave the
card half empty (a decode tick's few rows against a narrow weight), the
contraction is split into ranges (`splits`) whose partial sums a second
pass adds in a fixed order: the same bits on every launch.  The split
reads the row tile of the kernel a launch takes, its blocks resident on
an SM and the card's SM count from the library (`occupancy`), which asks
the CUDA runtime.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul_ref import quant_matmul_ref

__all__ = ["occupancy", "plan", "quant_matmul", "splits"]

_BN, _BK = 128, 64            # every kernel's column tile and contraction step


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def splits(t: int, d: int, f: int, rows: int, resident: int, sms: int) -> tuple[int, int]:
    """(ranges, rows of D a range) the kernel splits the contraction into,
    for a kernel of `rows`-row tiles of which `resident` blocks fit on one
    of the card's `sms` SMs: as many equal ranges of whole 64-row steps as
    one wave of resident blocks holds beside the (row tile x column tile)
    grid, and one range once the grid alone fills a wave.  A part-filled
    second wave would double the time of a launch, so the grid never grows
    past one."""
    tiles = max(_cdiv(t, rows) * _cdiv(f, _BN), 1)
    steps = max(_cdiv(d, _BK), 1)
    want = min(max(sms * max(resident, 1) // tiles, 1), steps)
    per = _cdiv(steps, want)
    return _cdiv(steps, per), per * _BK


@functools.lru_cache(maxsize=1024)
def occupancy(device: int, dtype: int, code: int, t: int) -> tuple[int, int, int]:
    """(row tile, blocks resident on an SM, SMs) of the kernel a launch of
    `t` rows of x in `dtype` (a dtype code) on card `device` takes, from the
    CUDA runtime."""
    lib = _build.library()
    vals = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device):
        err = lib.repro_quant_matmul_occupancy(dtype, code, t, *(ctypes.byref(v) for v in vals))
    _build.check(lib, err, "quant_matmul occupancy")
    return tuple(v.value for v in vals)


def plan(x: torch.Tensor, qw: torch.Tensor) -> tuple[int, int]:
    """`splits` of a launch of x (T, D) against qw (D, F) on x's card."""
    t, d = x.shape
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    rows, resident, sms = occupancy(device, _build.dtype_code(x, "quant_matmul"),
                                    _build.CODE_FORMATS[qw.dtype], t)
    return splits(t, d, qw.shape[1], rows, resident, sms)


def quant_matmul(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or qw.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"quant_matmul: x must be (T, D), qw (D, F) and scale (F,), got "
                         f"{tuple(x.shape)}, {tuple(qw.shape)} and {tuple(scale.shape)}")
    t, d = x.shape
    f = qw.shape[1]
    if qw.shape[0] != d or scale.shape[0] != f:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)}, qw {tuple(qw.shape)} and scale "
                         f"{tuple(scale.shape)} do not chain")
    dtype = _build.dtype_code(x, "quant_matmul")
    if qw.dtype not in _build.CODE_FORMATS:
        raise TypeError(f"quant_matmul: codes of dtype {qw.dtype} (int8, float8_e4m3fn)")
    if scale.dtype != torch.float32:
        raise TypeError(f"quant_matmul: scale of dtype {scale.dtype} (float32)")
    if not (qw.device == x.device == scale.device):
        raise ValueError("quant_matmul: x, qw and scale must be on one device")
    _build.check_layout("quant_matmul", x, qw, scale)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, qw, scale)
    out = torch.empty((t, f), dtype=x.dtype, device=x.device)
    if t == 0 or f == 0:
        return out                                                  # nothing to launch
    lib = _build.library()
    n, kchunk = plan(x, qw)
    ws = torch.empty((n, t, f), dtype=torch.float32, device=x.device) if n > 1 else None
    with torch.cuda.device(x.device):
        err = lib.repro_quant_matmul(dtype, _build.CODE_FORMATS[qw.dtype], x.data_ptr(),
                                     qw.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                     None if ws is None else ws.data_ptr(), t, d, f, n, kchunk,
                                     _build.stream_of(x))
    _build.check(lib, err, "quant_matmul")
    _build.LAUNCHES["quant_matmul"] += 1
    return out
