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

Only the contiguous, full-precision forms are ported: the paged
(``block_table``), sliding-window (``window``) and quantized-KV
(``k_scale``/``v_scale``) arguments of the decode and chunk references
raise NotImplementedError.

`masked_attention_ref` is the plain version of the flash kernel's own
signature (per-batch ``kv_len`` and ``q_start``): the kernel wrapper takes
it for tensors on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "chunk_attention_ref", "decode_attention_ref",
           "masked_attention_ref"]

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


def _contiguous_only(block_table, window, k_scale, v_scale) -> None:
    for name, arg in (("block_table", block_table), ("window", window),
                      ("k_scale", k_scale), ("v_scale", v_scale)):
        if arg is not None:
            raise NotImplementedError(
                f"{name}: the paged, windowed and quantized-KV attention forms "
                "are not ported yet")


def decode_attention_ref(q, k_cache, v_cache, pos, block_table=None, window=None,
                         k_scale=None, v_scale=None, *, scale=None) -> torch.Tensor:
    """Single-token attention against a (possibly longer) cache.

    q: (B, 1, H, Dh); caches: (B, Smax, KV, Dh); pos: int, () or (B,) int —
    the index of the new token, per batch row when a vector; keys at
    positions > pos are masked (cache slots not yet written).
    """
    _contiguous_only(block_table, window, k_scale, v_scale)
    b, _, h, dh = q.shape
    kv = k_cache.shape[2]
    group = h // kv
    scale = dh ** -0.5 if scale is None else scale
    pos = torch.as_tensor(pos, device=q.device)
    lim = pos.reshape(-1, 1, 1, 1) if pos.dim() else pos
    qg = q.reshape(b, kv, group, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg * scale, k_cache).float()
    ki = torch.arange(k_cache.shape[1], device=q.device)[None, None, None, :]
    scores = torch.where(ki <= lim, scores, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, dh).to(q.dtype)


def chunk_attention_ref(q, k_cache, v_cache, pos, block_table=None, window=None,
                        k_scale=None, v_scale=None, *, scale=None) -> torch.Tensor:
    """Chunked-prefill attention: C new queries against a partial cache.

    q: (B, C, H, Dh), already rotary-encoded at global positions
    pos..pos+C-1; caches: (B, Smax, KV, Dh) with the chunk's keys/values
    already written there.  Query i attends cache keys <= pos + i.
    pos: int, () or (B,) int.
    """
    _contiguous_only(block_table, window, k_scale, v_scale)
    b, c, h, dh = q.shape
    kv = k_cache.shape[2]
    group = h // kv
    scale = dh ** -0.5 if scale is None else scale
    pos = torch.as_tensor(pos, device=q.device)
    base = pos.reshape(-1, 1) if pos.dim() else pos.reshape(1, 1)
    lim = base + torch.arange(c, device=q.device)[None, :]              # (B|1, C)
    qg = q.reshape(b, c, kv, group, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg * scale, k_cache).float()
    ki = torch.arange(k_cache.shape[1], device=q.device)[None, None, :]
    valid = ki <= lim[..., None]                                         # (B|1, C, S)
    scores = torch.where(valid[:, None, None], scores, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, c, h, dh).to(q.dtype)


def masked_attention_ref(q, k, v, kv_len, q_start, *, causal: bool,
                         scale: float) -> torch.Tensor:
    """The flash kernel's function in plain PyTorch, fp32 throughout.

    kv_len, q_start: (B,) int tensors.  Query i of row b (global position
    q_start[b] + i) sees keys j < kv_len[b] and, when causal,
    j <= q_start[b] + i; V rows at j >= kv_len[b] count as zero.
    """
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = q.reshape(b, sq, kv, group, dh).float() * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    ki = torch.arange(sk, device=q.device)
    mask = (ki[None, :] < kv_len[:, None])[:, None, :]                  # (B, 1, Sk)
    if causal:
        qi = torch.arange(sq, device=q.device)[None, :, None] + q_start[:, None, None]
        mask = mask & (ki[None, None, :] <= qi)                         # (B, Sq, Sk)
    s = torch.where(mask[:, None, None], s, _NEG)
    vf = torch.where((ki[None, :] < kv_len[:, None])[..., None, None], v.float(), 0.0)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
    out = out / torch.clamp_min(p.sum(dim=-1), 1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)
