"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` in its contiguous,
full-precision form.  One kernel serves the three serving geometries
through the adapters in kernels/ops.py:

  * prefill  — ``kv_len = Sk``, ``q_start = Sk - Sq`` (static diagonal:
    blocks above it are skipped);
  * decode   — ``Sq == 1``, per-row ``kv_len = pos + 1``, not causal;
  * chunked prefill — ``Sq == C`` queries at ``q_start = pos`` against the
    cache, ``kv_len = pos + C``.

The arguments are checked as the kernel needs them on either device
(dtype, shapes, one device, layout); then a CUDA tensor launches the
kernel (or raises) and a CPU tensor takes the plain version,
`masked_attention_ref`.  ``op`` names the op a launch
serves in the launch count (`_build.LAUNCHES`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention_ref import masked_attention_ref

__all__ = ["flash_attention", "HEAD_DIMS"]

HEAD_DIMS = (64, 128)   # head widths the kernel is instantiated for


def _rows(x, default: int, b: int, device) -> torch.Tensor:
    """() or (B,) int -> a (B,) int32 tensor on `device`, as the Pallas
    wrapper broadcasts its kv_len / q_start meta rows.  A Python int
    becomes a fill on the device, not a host-to-device copy."""
    if x is None or isinstance(x, int):
        return torch.full((b,), default if x is None else x, dtype=torch.int32, device=device)
    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    if t.dim() > 1 or (t.dim() == 1 and t.shape[0] != b):
        raise ValueError(f"per-batch row of shape {tuple(t.shape)} for batch {b}")
    return t.expand(b).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len=None, q_start=None, *, causal: bool = True,
                    scale: float | None = None, op: str = "attention") -> torch.Tensor:
    """q (B, Sq, H, Dh), k/v (B, Sk, KV, Dh) -> (B, Sq, H, Dh) in q's dtype.

    kv_len: () or (B,) int — keys at positions >= kv_len are masked
    (None -> Sk).  q_start: () or (B,) int — global position of query 0
    for the causal mask (None -> Sk - Sq, the static prefill diagonal).
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if h % kv:
        raise ValueError(f"GQA requires H % KV == 0, got {h} % {kv}")
    if k.shape != (b, sk, kv, dh) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    scale = dh ** -0.5 if scale is None else scale
    static_diag = q_start is None
    code = _build.dtype_code(q, "flash_attention")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v dtypes differ ({q.dtype}, {k.dtype}, "
                         f"{v.dtype})")
    if not all(t.device == q.device for t in (k, v)):
        raise ValueError("flash_attention: q, k and v must be on one device")
    _build.check_layout("flash_attention", q, k, v)
    kv_len = _rows(kv_len, sk, b, q.device)
    q_start = _rows(q_start, sk - sq, b, q.device)
    if q.device.type == "cpu":
        return masked_attention_ref(q, k, v, kv_len, q_start, causal=causal, scale=scale)
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} not supported on the card "
                         f"(built for {HEAD_DIMS})")
    lib = _build.library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            code, dh, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kv_len.data_ptr(), q_start.data_ptr(), b, sq, sk, h, kv, float(scale),
            int(causal), int(static_diag), _build.stream_of(q))
    _build.check(lib, err, "flash_attention")
    _build.LAUNCHES[op] += 1
    return out
