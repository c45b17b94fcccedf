"""Transformer layers of the dense text decoder, in PyTorch.

A port of `repro/models/layers.py` for the serving path, over a
contiguous KV cache or a paged one, with an optional sliding window.
Every hardware-sensitive op goes through the container's binding
(``binding["rmsnorm"]``, ``binding["attention"]``, ...); the plain large
products (projections, full-precision MLP) stay matrix products, as the
JAX package left them to XLA.

A weight leaf may be in storage form, ``{"q", "scale"}`` (int8 or fp8
codes, float32 scales with axis -2 reduced away): the MLP sends such
leaves to ``binding["quant_matmul"]``, and the attention projections
dequantize them first (`dequant_param`), exactly where the JAX layers do.

Tensor layouts are the JAX package's: ``wq (d, h, dh)``, ``wk/wv
(d, kv, dh)``, ``wo (h, dh, d)``, activations ``(B, S, H, Dh)``, so
weights cross over leaf for leaf.

The KV cache is updated in place (`_cache_write`, `_paged_decode_write`,
the paged chunk's page copy): JAX returns a new buffer, which on the card
would cost a second copy of the cache per step.  A quantized cache (int8
or fp8 k/v with ``k_scale``/``v_scale`` rows, one static scale a slot)
takes every write through `quant_update` first, so the chunk's queries
see their own keys through the quantized cache, as in JAX; the scales
ride to the attention ops, which dequantize in the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.quant import dequantize, format_of, to_codes
from repro_torch.models.schema import LeafSpec

__all__ = ["rotary", "norm_schema", "norm_apply", "attention_schema", "attention_apply",
           "attention_decode", "attention_chunk", "dequant_param", "is_quantized",
           "mlp_schema", "mlp_apply", "paged_write_index", "quant_update"]


def is_quantized(p) -> bool:
    """Whether a weight leaf is in storage form: a ``{"q", "scale"}``
    mapping (or the model's subtree of the two)."""
    return not isinstance(p, torch.Tensor) and "q" in p and "scale" in p


def dequant_param(p, dtype: torch.dtype = torch.float32):
    """Materialize a storage-form weight ``{"q", "scale"}`` (codes with
    axis -2 reduced to per-channel scales) as a dense tensor of `dtype`;
    full-precision leaves pass through untouched."""
    if is_quantized(p):
        return dequantize(p["q"], p["scale"], axis=-2, dtype=dtype)
    return p


# --------------------------------------------------------------------------- #
# rotary
# --------------------------------------------------------------------------- #
def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (S,) or (B, S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    pos = positions.to(torch.float32)
    if positions.dim() == 1:
        ang = pos[None, :, None] * freqs[None, None, :]
    else:
        ang = pos[:, :, None] * freqs[None, None, :]
    ang = ang[:, :, None, :]                                 # (B|1, S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #
def norm_schema(cfg: ModelConfig) -> dict[str, LeafSpec]:
    return {"scale": LeafSpec((cfg.d_model,), ("norm",), init="ones")}


def norm_apply(params, x: torch.Tensor, cfg: ModelConfig, binding, eps: float = 1e-6):
    return binding["rmsnorm"](x, params["scale"], eps=eps)


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #
def attention_schema(cfg: ModelConfig, n_heads: int | None = None) -> dict[str, LeafSpec]:
    d, h, kv, dh = cfg.d_model, n_heads or cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    leaves = {
        "wq": LeafSpec((d, h, dh), ("embed", "heads", "head_dim"), init="scaled"),
        "wk": LeafSpec((d, kv, dh), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wv": LeafSpec((d, kv, dh), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wo": LeafSpec((h, dh, d), ("heads", "head_dim", "embed"), init="scaled"),
    }
    if cfg.qkv_bias:
        leaves["bq"] = LeafSpec((h, dh), ("heads", "head_dim"), init="zeros")
        leaves["bk"] = LeafSpec((kv, dh), ("kv_heads", "head_dim"), init="zeros")
        leaves["bv"] = LeafSpec((kv, dh), ("kv_heads", "head_dim"), init="zeros")
    return leaves


def _proj(x: torch.Tensor, w) -> torch.Tensor:
    """(B, S, d) @ (d, heads, dh) -> (B, S, heads, dh), contiguous."""
    b, s, d = x.shape
    w = dequant_param(w, x.dtype)
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def _out(o: torch.Tensor, wo) -> torch.Tensor:
    """(B, S, H, Dh) @ (H, Dh, d) -> (B, S, d)."""
    b, s, h, dh = o.shape
    wo = dequant_param(wo, o.dtype)
    return (o.reshape(b * s, h * dh) @ wo.reshape(h * dh, -1)).view(b, s, -1)


def _qkv(params, x, cfg: ModelConfig, positions):
    q, k, v = _proj(x, params["wq"]), _proj(x, params["wk"]), _proj(x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return rotary(q, positions, cfg.rope_theta), rotary(k, positions, cfg.rope_theta), v


def attention_apply(params, x: torch.Tensor, cfg: ModelConfig, binding, *,
                    positions: torch.Tensor, causal: bool = True):
    """Full-sequence attention (prefill).  Returns (out, {"k", "v"})."""
    q, k, v = _qkv(params, x, cfg, positions)
    out = binding["attention"](q, k, v, causal=causal)
    return _out(out, params["wo"]), {"k": k, "v": v}


def quant_update(upd: torch.Tensor, scale, dtype: torch.dtype) -> torch.Tensor:
    """Quantize fresh k/v `upd` onto a quantized cache's grid with the
    slot's static scale (() or (B,) float32): divide in float32 by the
    scale (not a multiply by its reciprocal), then int8 rounds half to
    even and clips to +-127, fp8 clips to +-448 and casts.  A plain
    ``.to(int8)`` would truncate; this is the inverse of the kernels'
    dequantization, as JAX's ``layers._quant_update``."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=upd.device)
    s = s.reshape(tuple(s.shape) + (1,) * (upd.dim() - s.dim()))
    return to_codes(upd.to(torch.float32) / s, format_of(dtype))


def _quantized_kv(cache: dict, k: torch.Tensor, v: torch.Tensor):
    """(k, v, scale args of the attention op): k/v quantized onto the
    cache's grid when it carries scales, else as they are, no scales."""
    k_scale, v_scale = cache.get("k_scale"), cache.get("v_scale")
    if k_scale is None:
        return k, v, ()
    k = quant_update(k, k_scale, cache["k"].dtype)
    v = quant_update(v, v_scale, cache["v"].dtype)
    return k, v, (k_scale, v_scale)


def _cache_write(buf: torch.Tensor, upd: torch.Tensor, pos) -> torch.Tensor:
    """Write `upd` (B, S, KV, Dh) into `buf` (B, Smax, KV, Dh) in place at
    sequence offset `pos` and return `buf`.

    pos is an int (one offset for every row) or a (B,) int tensor (every
    row at its own position; S must be 1).  Offsets are clamped so the
    write stays inside the buffer, as JAX's dynamic_update_slice does.
    """
    upd = upd.to(buf.dtype)
    smax, s = buf.shape[1], upd.shape[1]
    if isinstance(pos, int):
        start = min(max(pos, 0), smax - s)
        buf[:, start:start + s] = upd
        return buf
    if s != 1:
        raise ValueError(f"per-row cache writes take one token, got {s}")
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, pos.long().clamp(0, smax - 1)] = upd[:, 0]
    return buf


def paged_write_index(pos: torch.Tensor, block_tables: torch.Tensor,
                      page: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Where each row's decode token lands in a page pool: (physical page
    ``block_tables[b, pos[b] // page]``, offset ``pos[b] % page``), both
    (B,) int64.  The same for every layer of a tick, so the model computes
    it once per tick."""
    pos = pos.long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    return block_tables[rows, pos // page].long(), pos % page


def _paged_decode_write(pool: torch.Tensor, upd: torch.Tensor, write_at) -> torch.Tensor:
    """Scatter each row's new token into its page, in place, at `write_at`
    (`paged_write_index`): logical position p of row b lands in page
    block_tables[b, p // page] at offset p % page.  Parked rows (table row
    all zeros) write into the reserved park page: harmless garbage, their
    logits are discarded."""
    phys, off = write_at
    pool[phys, off] = upd[:, 0].to(pool.dtype)
    return pool


def attention_decode(params, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                     cfg: ModelConfig, binding, *, block_tables: torch.Tensor | None = None,
                     window: int | None = None, write_at=None):
    """One-token attention against the cache; writes the new k/v in place.

    x: (B, 1, D); cache k/v: (B, Smax, KV, Dh); pos: (B,) int — each row's
    new-token index (continuous batching).  With `block_tables`
    ((B, nblocks) int32 on the device) the cache k/v are page pools
    (P, page, KV, Dh) shared by all slots: the write scatters through the
    table at `write_at` (`paged_write_index`, computed once per tick by
    the caller and required with `block_tables`) and the op gathers
    through it.  With `window` only the trailing `window` cache slots are
    attended; out-of-window pages may already have been recycled.  With
    ``k_scale``/``v_scale`` rows in `cache` the new k/v are quantized
    before the write (`quant_update`).
    """
    q, k, v = _qkv(params, x, cfg, pos[:, None])
    k, v, scales = _quantized_kv(cache, k, v)
    if block_tables is not None:
        k_cache = _paged_decode_write(cache["k"], k, write_at)
        v_cache = _paged_decode_write(cache["v"], v, write_at)
    else:
        k_cache = _cache_write(cache["k"], k, pos)
        v_cache = _cache_write(cache["v"], v, pos)
    out = binding["decode_attention"](q, k_cache, v_cache, pos, block_tables, window, *scales)
    return _out(out, params["wo"]), {"k": k_cache, "v": v_cache}


def attention_chunk(params, x: torch.Tensor, cache: dict, pos: int, cfg: ModelConfig,
                    binding, *, block_tables: torch.Tensor | None = None,
                    window: int | None = None, write_page: int | None = None):
    """Chunked-prefill attention: C prompt tokens at global positions
    pos..pos+C-1 against the partially filled cache.

    Writes the chunk's k/v into [pos, pos+C) in place and attends through
    ``binding["chunk_attention"]`` (query i sees cache keys <= pos+i).
    Positions past the prompt's true end carry garbage k/v, but every later
    query sees those slots only after they are overwritten.

    With `block_tables` (the prefilling slot's (1, nblocks) int32 table on
    the device, B == 1) the cache k/v are page pools, and the serving
    invariant page == C makes the chunk's write exactly one page:
    `write_page`, the physical page block_tables[0, pos // page], which
    the caller reads from its host copy of the table (required with
    `block_tables`).  With `window` each chunk query
    attends only its trailing `window` keys.  With ``k_scale``/``v_scale``
    rows in `cache` the chunk's k/v are quantized before the write, so its
    queries attend their own keys through the quantized cache.
    """
    c = x.shape[1]
    chunk_pos = pos + torch.arange(c, device=x.device)
    q, k, v = _qkv(params, x, cfg, chunk_pos)
    k, v, scales = _quantized_kv(cache, k, v)
    if block_tables is not None:
        page = cache["k"].shape[1]
        if c != page:
            raise ValueError(f"paged prefill requires chunk == page, {c} != {page}")
        cache["k"][write_page] = k[0].to(cache["k"].dtype)
        cache["v"][write_page] = v[0].to(cache["v"].dtype)
        k_cache, v_cache = cache["k"], cache["v"]
    else:
        k_cache = _cache_write(cache["k"], k, pos)
        v_cache = _cache_write(cache["v"], v, pos)
    out = binding["chunk_attention"](q, k_cache, v_cache, pos, block_tables, window, *scales)
    return _out(out, params["wo"]), {"k": k_cache, "v": v_cache}


# --------------------------------------------------------------------------- #
# dense MLP
# --------------------------------------------------------------------------- #
def mlp_schema(cfg: ModelConfig, d_ff: int | None = None) -> dict[str, LeafSpec]:
    """SiLU-GLU MLP leaves of width ``d_ff`` (default ``cfg.d_ff``; the MoE
    shared experts pass theirs)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_in": LeafSpec((d, f), ("embed", "ff"), init="scaled"),
        "w_out": LeafSpec((f, d), ("ff", "embed"), init="scaled"),
        "w_gate": LeafSpec((d, f), ("embed", "ff"), init="scaled"),
    }


def mlp_apply(params, x: torch.Tensor, binding=None) -> torch.Tensor:
    """SiLU-GLU MLP; its width is the leaves'.  A storage-form leaf goes
    through ``binding["quant_matmul"]`` on the (B*S, D) rows, which scales
    the product per output channel, so the dense weight is never
    materialized (a binding is then required); a full-precision leaf stays
    a matrix product."""

    def matmul(y, w):
        if is_quantized(w):
            if binding is None:
                raise ValueError("mlp_apply: a quantized weight needs a binding with "
                                 "quant_matmul")
            b, s, d = y.shape
            return binding["quant_matmul"](y.reshape(b * s, d), w["q"],
                                           w["scale"]).view(b, s, -1)
        return y @ w

    h = F.silu(matmul(x, params["w_gate"])) * matmul(x, params["w_in"])
    return matmul(h, params["w_out"])
