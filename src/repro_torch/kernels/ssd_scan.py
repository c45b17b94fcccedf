"""Mamba-2 SSD chunked scan on the card: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``:
x (B, S, H, P) float32 or bfloat16, dt (B, S, H) float32, A (H,) float32,
B and C (B, S, G, N) in x's dtype; returns y (B, S, H, P) in x's dtype and
the final state (B, H, N, P) float32.  ``chunk`` is used as given: it must
divide S and lie in [1, 128] (the model picks it, as the JAX layer does),
since it sets the order of the sums.

The arguments are checked as the kernel needs them on any device; then a
CUDA tensor launches the kernel (or raises) and a CPU tensor takes the
plain version, `ssd_scan_ref`.  An empty x launches nothing: y is empty
and the state zero, as the plain version gives it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan_ref import ssd_scan_ref

__all__ = ["ssd_scan", "MAX_CHUNK", "MAX_STATE"]

MAX_CHUNK = 128   # the kernel's largest chunk and state size (rows a block walks)
MAX_STATE = 128


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError("ssd_scan: x (B, S, H, P), dt (B, S, H), A (H,), B and C (B, S, G, N)")
    b, s, h, _ = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(Bm.shape) != (b, s, g, n) or tuple(Cm.shape) != tuple(Bm.shape)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)} "
                         "do not agree")
    if g < 1 or h % g:
        raise ValueError(f"ssd_scan: {h} heads do not split into {g} groups")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan: state size {n} outside [1, {MAX_STATE}]")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} must lie in [1, {MAX_CHUNK}] and "
                         f"divide S = {s}")
    _build.dtype_code(x, "ssd_scan")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: B {Bm.dtype} and C {Cm.dtype} must have x's dtype {x.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt {dt.dtype} and A {A.dtype} must be float32")
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError("ssd_scan: x, dt, A, B and C must be on one device")
    if not all(t.is_contiguous() for t in (x, dt, A, Bm, Cm)):
        raise ValueError("ssd_scan: tensors must be contiguous")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    chunk = int(chunk)
    _check(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    if x.numel() == 0:                                              # nothing to launch
        return y, torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    lib = _build.library()
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.repro_ssd_scan(_build.dtype_code(x, "ssd_scan"), x.data_ptr(), dt.data_ptr(),
                                 A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                                 state.data_ptr(), b, s, h, p, g, n, chunk,
                                 _build.stream_of(x))
    _build.check(lib, err, "ssd_scan")
    _build.LAUNCHES["ssd_scan"] += 1
    return y, state
