"""Plain PyTorch (GQA) attention: the references the CUDA kernel is held
against, copied from `repro/kernels/flash_attention_ref.py`.

Two evaluation strategies for whole-sequence attention, numerically the
same function:
  * plain — materialized (Sq, Sk) scores;
  * chunked — online softmax over KV chunks: O(Sq * chunk) live memory,
    which the op reference selects above 2k keys (kernels/ops.py).

Shapes:
  q: (B, Sq, H,  Dh)
  k: (B, Sk, KV, Dh)
  v: (B, Sk, KV, Dh)     with H % KV == 0; head h reads KV head h // (H // KV)
Returns (B, Sq, H, Dh).

The decode and chunk references take the paged (``block_table``: the
caches are (P, page, KV, Dh) pools gathered per row, `_gather_pages`),
sliding-window (``window``) and quantized-KV (``k_scale``/``v_scale``:
int8 or float8_e4m3fn caches, dequantized after the gather,
`_dequant_cache`) forms.  With a quantized cache the scores and p.V run
in float32, as JAX's einsum promotes q against the dequantized cache
(torch's einsum does not promote, so `_einsum` casts as JAX does).

`masked_attention_ref` is the plain version of the flash kernel's own
signature (per-batch ``kv_len``, ``q_start``, window-start and scale
rows, paged or contiguous K/V): the kernel wrapper takes it for tensors
on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.quant import STORAGE_DTYPES

__all__ = ["attention_ref", "check_scales", "chunk_attention_ref",
           "decode_attention_ref", "masked_attention_ref", "windowed_attention_ref"]

_NEG = -1e30


def _plain(q, k, v, causal, scale):
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    group = h // kv
    qg = q.reshape(b, sq, kv, group, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg * scale, k).float()
    if causal:
        sk = k.shape[1]
        # causal alignment for prefill: query i attends keys <= i + (sk - sq)
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(qi >= ki, scores, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return out.reshape(b, sq, h, dh)


def _chunked(q, k, v, causal, scale, chunk):
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = (q.reshape(b, sq, kv, group, dh) * scale).float()
    q_pos = torch.arange(sq, device=q.device) + (sk - sq)
    m = torch.full((b, kv, group, sq), _NEG, device=q.device)
    l = torch.zeros((b, kv, group, sq), device=q.device)
    acc = torch.zeros((b, kv, group, sq, dh), device=q.device)
    for c0 in range(0, sk, chunk):
        kch = k[:, c0:c0 + chunk].float()
        vch = v[:, c0:c0 + chunk].float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kch)
        if causal:
            k_pos = c0 + torch.arange(chunk, device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vch)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: float | None = None,
                  chunk_kv: int | None = None) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    sk = k.shape[1]
    if chunk_kv and sk > chunk_kv and sk % chunk_kv == 0:
        return _chunked(q, k, v, causal, scale, chunk_kv)
    return _plain(q, k, v, causal, scale)


def windowed_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window, *,
                           scale: float | None = None) -> torch.Tensor:
    """Sliding-window causal attention.

    Query at global position g attends keys in (g - window, g]: the causal
    mask plus a lower bound `window` wide.  Global query positions follow
    the prefill alignment (query i sits at i + Sk - Sq), so with window >= Sk
    this is exactly `attention_ref(..., causal=True)`.
    window: int, () or (B,) int.
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(b, sq, kv, group, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg * scale, k).float()
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)          # (Sq, 1)
    ki = torch.arange(sk, device=q.device)[None, :]                      # (1, Sk)
    w = _per_row(window, b, q.device)
    mask = (ki <= qi)[None] & (ki > qi - w[:, None, None])               # (B, Sq, Sk)
    scores = torch.where(mask[:, None, None], scores, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return out.reshape(b, sq, h, dh)


def _per_row(x, b: int, device) -> torch.Tensor:
    """int, () or (B,) int -> a (B,) int64 tensor."""
    return torch.as_tensor(x, device=device).long().expand(b)


def _gather_pages(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """(P, page, KV, Dh) pool + (B, nblocks) table -> the logical
    (B, nblocks * page, KV, Dh) cache each batch row sees."""
    b, n = block_table.shape
    page = pool.shape[1]
    return pool[block_table.long()].reshape(b, n * page, *pool.shape[2:])


def check_scales(k_cache: torch.Tensor, k_scale, v_scale) -> None:
    """A quantized cache comes with both scales: one scale alone, or an
    int8 / fp8 cache without them, is refused."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("quantized KV needs both k_scale and v_scale")
    if k_scale is None and k_cache.dtype in STORAGE_DTYPES.values():
        raise ValueError(f"a {k_cache.dtype} KV cache needs k_scale and v_scale")


def _dequant_cache(cache: torch.Tensor, scale) -> torch.Tensor:
    """Dequantize an int8 / fp8 logical cache (B, S, KV, Dh) with a () or
    (B,) float32 scale: codes to float32, times the row's scale."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=cache.device)
    if s.dim():
        s = s.reshape(-1, 1, 1, 1)
    return cache.to(torch.float32) * s


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum on the promoted dtype of its operands, as jnp.einsum: a bf16
    q against a dequantized float32 cache computes in float32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def decode_attention_ref(q, k_cache, v_cache, pos, block_table=None, window=None,
                         k_scale=None, v_scale=None, *, scale=None) -> torch.Tensor:
    """Single-token attention against a (possibly longer) cache.

    q: (B, 1, H, Dh); caches: (B, Smax, KV, Dh); pos: int, () or (B,) int —
    the index of the new token, per batch row when a vector; keys at
    positions > pos are masked (cache slots not yet written).  With
    `block_table` ((B, nblocks) int) the caches are page pools
    (P, page, KV, Dh) and each row's logical cache is gathered through its
    table row first.  `window` (int, () or (B,) int) additionally masks
    keys at positions <= pos - window: only the trailing `window` cache
    slots are attended.  With `k_scale`/`v_scale` (() or (B,) float32)
    the caches are int8 / fp8 and dequantized (after the gather) before
    the math.
    """
    check_scales(k_cache, k_scale, v_scale)
    if block_table is not None:
        k_cache = _gather_pages(k_cache, block_table)
        v_cache = _gather_pages(v_cache, block_table)
    if k_scale is not None:
        k_cache = _dequant_cache(k_cache, k_scale)
        v_cache = _dequant_cache(v_cache, v_scale)
    b, _, h, dh = q.shape
    kv = k_cache.shape[2]
    group = h // kv
    scale = dh ** -0.5 if scale is None else scale
    pos = torch.as_tensor(pos, device=q.device)
    lim = pos.reshape(-1, 1, 1, 1) if pos.dim() else pos
    qg = q.reshape(b, kv, group, dh)
    scores = _einsum("bkgd,bskd->bkgs", qg * scale, k_cache).float()
    ki = torch.arange(k_cache.shape[1], device=q.device)[None, None, None, :]
    valid = ki <= lim
    if window is not None:
        valid = valid & (ki > lim - _per_row(window, b, q.device).reshape(-1, 1, 1, 1))
    scores = torch.where(valid, scores, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = _einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, dh).to(q.dtype)


def chunk_attention_ref(q, k_cache, v_cache, pos, block_table=None, window=None,
                        k_scale=None, v_scale=None, *, scale=None) -> torch.Tensor:
    """Chunked-prefill attention: C new queries against a partial cache.

    q: (B, C, H, Dh), already rotary-encoded at global positions
    pos..pos+C-1; caches: (B, Smax, KV, Dh) with the chunk's keys/values
    already written there.  Query i attends cache keys <= pos + i.
    pos: int, () or (B,) int.  With `block_table` ((B, nblocks) int) the
    caches are page pools (P, page, KV, Dh), gathered per row as in
    `decode_attention_ref`.  `window` (int, () or (B,) int) additionally
    masks keys at positions <= pos + i - window.  `k_scale`/`v_scale` mark
    quantized caches, dequantized as in `decode_attention_ref`.
    """
    check_scales(k_cache, k_scale, v_scale)
    if block_table is not None:
        k_cache = _gather_pages(k_cache, block_table)
        v_cache = _gather_pages(v_cache, block_table)
    if k_scale is not None:
        k_cache = _dequant_cache(k_cache, k_scale)
        v_cache = _dequant_cache(v_cache, v_scale)
    b, c, h, dh = q.shape
    kv = k_cache.shape[2]
    group = h // kv
    scale = dh ** -0.5 if scale is None else scale
    pos = torch.as_tensor(pos, device=q.device)
    base = pos.reshape(-1, 1) if pos.dim() else pos.reshape(1, 1)
    lim = base + torch.arange(c, device=q.device)[None, :]              # (B|1, C)
    qg = q.reshape(b, c, kv, group, dh)
    scores = _einsum("bqkgd,bskd->bkgqs", qg * scale, k_cache).float()
    ki = torch.arange(k_cache.shape[1], device=q.device)[None, None, :]
    valid = ki <= lim[..., None]                                         # (B|1, C, S)
    if window is not None:
        w = _per_row(window, b, q.device)
        valid = valid & (ki > (lim - w[:, None])[..., None])
    scores = torch.where(valid[:, None, None], scores, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = _einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, c, h, dh).to(q.dtype)


def masked_attention_ref(q, k, v, kv_len, q_start, *, causal: bool, scale: float,
                         block_tables=None, win_start=None, k_scale=None,
                         v_scale=None) -> torch.Tensor:
    """The flash kernel's function in plain PyTorch, fp32 throughout.

    kv_len, q_start: (B,) int tensors.  Query i of row b (global position
    q_start[b] + i) sees keys j < kv_len[b] and, when causal,
    j <= q_start[b] + i, and, with the (B,) window-start row `win_start`,
    j >= win_start[b] + i.  V rows at j >= kv_len[b] or j < win_start[b]
    count as zero.  With `block_tables` ((B, nblocks) int) k/v are
    (P, page, KV, Dh) pools, gathered per row first.  With the (B,)
    float32 rows `k_scale`/`v_scale` k/v are int8 / fp8 codes, each row's
    times its scale.
    """
    if block_tables is not None:
        k, v = _gather_pages(k, block_tables), _gather_pages(v, block_tables)
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf, vf = kf * k_scale.view(-1, 1, 1, 1), vf * v_scale.view(-1, 1, 1, 1)
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = q.reshape(b, sq, kv, group, dh).float() * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf)
    ki = torch.arange(sk, device=q.device)
    qi = torch.arange(sq, device=q.device)[None, :, None]
    live = ki[None, :] < kv_len[:, None]                                # (B, Sk)
    mask = live[:, None, :]                                             # (B, 1, Sk)
    if causal:
        mask = mask & (ki[None, None, :] <= qi + q_start[:, None, None])  # (B, Sq, Sk)
    if win_start is not None:
        mask = mask & (ki[None, None, :] >= qi + win_start[:, None, None])
        live = live & (ki[None, :] >= win_start[:, None])
    s = torch.where(mask[:, None, None], s, _NEG)
    vf = torch.where(live[..., None, None], vf, 0.0)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
    out = out / torch.clamp_min(p.sum(dim=-1), 1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)
