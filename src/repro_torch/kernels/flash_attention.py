"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` in its contiguous
and paged, full and sliding-window, full-precision and quantized-KV
forms.  One kernel
serves the three serving geometries through the adapters in
kernels/ops.py:

  * prefill  — ``kv_len = Sk``, ``q_start = Sk - Sq`` (static diagonal:
    blocks above it are skipped);
  * decode   — ``Sq == 1``, per-row ``kv_len = pos + 1``, not causal;
  * chunked prefill — ``Sq == C`` queries at ``q_start = pos`` against the
    cache, ``kv_len = pos + C``.

Paged KV (``block_tables``): k/v are (P, page, KV, Dh) pools and logical
key p of batch row b lives at ``pool[block_tables[b, p // page], p % page]``;
the kernel translates addresses per key row, so a tile may span pages of
any size.  Sliding window (``window`` W): the wrapper adds the per-row
window start ``ws = kv_len - Sq - W + 1`` and query i attends keys
``>= ws + i`` only; key tiles wholly below the window are skipped.
Quantized KV (``k_scale``/``v_scale``): k/v are int8 or float8_e4m3fn
codes, and the kernel multiplies each loaded row by its batch row's
float32 scale before the fp32 math; the wrapper broadcasts the () or
(B,) scales to (B,) rows on q's device.

The library picks one of three kernels by q's dtype and Sq, and reports
the kernel each launch took; the wrapper counts it by (op, kernel) in
`_build.KERNEL_LAUNCHES` (names in `KERNELS`):

  * ``tensor_core`` — bf16 q with more than 16 rows (whole prompts,
    prefill chunks, windowed_attention): bound by the bf16 tensor cores
    (~2 Dh operations a key byte, times the rows), so the products run
    there, `mma.sync` with fp32 sums and p rounded to bf16 for p.V;
  * ``split_decode`` — bf16 q with one row (every decode, and a causal
    launch of one row, whose limit is min(kv_len, q_start + 1)): bound by
    reading the cache once (~5 operations a byte at qwen's GQA group of
    5), so a block owns one (batch row, KV head, 128-key split) and the
    query heads of that KV head's group as the 16 rows of one
    tensor-core tile, and reads each K/V row once with all its copies in
    flight; `mma.sync` with fp32 sums and p rounded to bf16 for p.V, so
    the arithmetic after the bytes land stays short; a second kernel
    combines the splits in split order.  Its fp32 workspace of partial
    results is allocated here, at the size the library's own rule gives
    (`_workspace_floats`); both kernels count as one launch;
  * ``fma`` — fp32 q, and bf16 q with 2-16 rows (no serve run): fp32
    FMAs.

The arguments are checked as the kernel needs them on either device
(dtype, shapes, one device, layout); then a CUDA tensor launches the
kernel (or raises) and a CPU tensor takes the plain version,
`masked_attention_ref`.  ``op`` names the op a launch
serves in the launch count (`_build.LAUNCHES`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention_ref import check_scales, masked_attention_ref

__all__ = ["flash_attention", "occupancy", "HEAD_DIMS", "KERNELS"]

HEAD_DIMS = (64, 128)   # head widths the kernel is instantiated for
KERNELS = ("fma", "tensor_core", "split_decode")   # the library's kernel numbers, by name


def occupancy(dtype: torch.dtype, kv_dtype: torch.dtype, dh: int, sq: int, *,
              paged: bool = False, windowed: bool = False) -> tuple[str, int, int, int]:
    """(kernel, query rows a block, threads, blocks resident on an SM) of
    the kernel instance a launch would take on the current card, as the
    library and the CUDA runtime report them; kv_dtype: the cache's (q's
    own, or a 1-byte code format)."""
    lib = _build.library()
    vals = [ctypes.c_int() for _ in range(4)]
    code = _build.CODE_FORMATS.get(kv_dtype, -1)
    err = lib.repro_flash_attention_occupancy(
        _build.dtype_code(torch.empty((), dtype=dtype), "flash_attention"), code, dh, sq,
        int(paged), int(windowed), *(ctypes.byref(v) for v in vals))
    _build.check(lib, err, "flash_attention occupancy")
    kernel, rows, threads, resident = (v.value for v in vals)
    return KERNELS[kernel], rows, threads, resident


@functools.lru_cache(maxsize=256)
def _workspace_floats(dtype: int, code: int, dh: int, b: int, sq: int, sk: int, h: int,
                      kv: int) -> int:
    """float32 workspace floats a launch needs, as the library's own rule
    gives them (the split decode kernel's partial results; 0 for the other
    kernels); code: the cache's format, -1 for q's own dtype."""
    lib = _build.library()
    n = ctypes.c_longlong()
    _build.check(lib, lib.repro_flash_attention_workspace(dtype, code, dh, b, sq, sk, h, kv,
                                                          ctypes.byref(n)),
                 "flash_attention workspace")
    return n.value


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


def _scale_row(x, b: int, device) -> torch.Tensor:
    """A () or (B,) float32 scale (a Python float, or a tensor on q's
    device) -> a (B,) float32 row on `device`."""
    if not isinstance(x, torch.Tensor):
        return torch.full((b,), float(x), dtype=torch.float32, device=device)
    if x.dtype != torch.float32:
        raise TypeError(f"flash_attention: scales must be float32, got {x.dtype}")
    if x.device != device:
        raise ValueError("flash_attention: scales must be on q's device")
    if x.dim() > 1 or (x.dim() == 1 and x.shape[0] != b):
        raise ValueError(f"flash_attention: scale of shape {tuple(x.shape)} for batch {b}")
    return x.expand(b).contiguous()


def _check_table(block_tables, q: torch.Tensor) -> None:
    """Check a paged call's table against q: dtype, shape, device, layout."""
    b = q.shape[0]
    if not isinstance(block_tables, torch.Tensor) or block_tables.dtype != torch.int32:
        raise TypeError("flash_attention: block_tables must be an int32 tensor")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"flash_attention: block_tables of shape "
                         f"{tuple(block_tables.shape)} for batch {b}")
    if block_tables.device != q.device:
        raise ValueError("flash_attention: block_tables must be on q's device")
    if not block_tables.is_contiguous():
        raise ValueError("flash_attention: block_tables must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len=None, q_start=None, *, causal: bool = True,
                    scale: float | None = None, op: str = "attention",
                    block_tables: torch.Tensor | None = None, window=None,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    """q (B, Sq, H, Dh), k/v (B, Sk, KV, Dh) -> (B, Sq, H, Dh) in q's dtype.

    kv_len: () or (B,) int — keys at positions >= kv_len are masked
    (None -> Sk).  q_start: () or (B,) int — global position of query 0
    for the causal mask (None -> Sk - Sq, the static prefill diagonal).
    block_tables: (B, nblocks) int32 on q's device — k/v are then
    (P, page, KV, Dh) pools, the page is k.shape[1], and
    Sk = nblocks * page.  window: int, () or (B,) int — sliding-window width.
    k_scale, v_scale: float, () or (B,) float32 on q's device, both or
    neither — k/v are then int8 or float8_e4m3fn codes (one format).
    """
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    paged = block_tables is not None
    if paged:
        _check_table(block_tables, q)
        page = k.shape[1]
        nblocks = block_tables.shape[1]
        sk = nblocks * page
        want = (k.shape[0], page, kv, dh)
    else:
        sk, nblocks, page = k.shape[1], 0, 0
        want = (b, sk, kv, dh)
    if h % kv:
        raise ValueError(f"GQA requires H % KV == 0, got {h} % {kv}")
    if k.shape != want or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    scale = dh ** -0.5 if scale is None else scale
    static_diag = q_start is None
    code = _build.dtype_code(q, "flash_attention")
    check_scales(k, k_scale, v_scale)
    quantized = k_scale is not None
    if quantized and (k.dtype not in _build.CODE_FORMATS or v.dtype != k.dtype):
        raise ValueError(f"flash_attention: scales with a {k.dtype} / {v.dtype} cache "
                         "(int8 or float8_e4m3fn codes, one format)")
    if not quantized and (k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError(f"flash_attention: q/k/v dtypes differ ({q.dtype}, {k.dtype}, "
                         f"{v.dtype})")
    if not all(t.device == q.device for t in (k, v)):
        raise ValueError("flash_attention: q, k and v must be on one device")
    _build.check_layout("flash_attention", q, k, v)
    if quantized:
        k_scale, v_scale = (_scale_row(x, b, q.device) for x in (k_scale, v_scale))
    kv_len = _rows(kv_len, sk, b, q.device)
    # q_start is read only by the causal mask: a launch without one passes
    # kv_len in its place, with no fill of its own
    q_start = _rows(q_start, sk - sq, b, q.device) if causal else kv_len
    win_start = None
    if window is not None:
        # ws = kv_len - Sq - W + 1; a width past Sk + Sq masks nothing more,
        # and clamping it there keeps ws inside int32
        if isinstance(window, int):
            win_start = kv_len - (min(window, sk + sq) + sq - 1)
        else:
            win_start = kv_len - _rows(window, 0, b, q.device).clamp(max=sk + sq) - (sq - 1)
    if q.device.type == "cpu":
        return masked_attention_ref(q, k, v, kv_len, q_start, causal=causal, scale=scale,
                                    block_tables=block_tables, win_start=win_start,
                                    k_scale=k_scale, v_scale=v_scale)
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} not supported on the card "
                         f"(built for {HEAD_DIMS})")
    lib = _build.library()
    out = torch.empty_like(q)
    floats = _workspace_floats(code, _build.CODE_FORMATS[k.dtype] if quantized else -1, dh, b,
                               sq, sk, h, kv)
    ws = torch.empty(floats, dtype=torch.float32, device=q.device) if floats else None
    took = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            code, _build.CODE_FORMATS.get(k.dtype, 0), dh, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), kv_len.data_ptr(), q_start.data_ptr(),
            block_tables.data_ptr() if paged else None, nblocks, page,
            k.shape[0] if paged else 0,
            None if win_start is None else win_start.data_ptr(),
            k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
            None if ws is None else ws.data_ptr(), b, sq, sk, h, kv, float(scale), int(causal),
            int(static_diag), _build.stream_of(q), ctypes.byref(took))
    _build.check(lib, err, "flash_attention")
    _build.LAUNCHES[op] += 1
    if took.value >= 0:
        _build.KERNEL_LAUNCHES[op, KERNELS[took.value]] += 1
    return out
