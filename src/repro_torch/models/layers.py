"""Transformer layers of the dense text decoder, in PyTorch.

A port of `repro/models/layers.py` for the full-precision serving path,
over a contiguous KV cache or a paged one, with an optional sliding
window.  Every hardware-sensitive op goes through the container's
binding (``binding["rmsnorm"]``, ``binding["attention"]``, ...); the plain
large products (projections, MLP) stay matrix products, as the JAX
package left them to XLA.

Tensor layouts are the JAX package's: ``wq (d, h, dh)``, ``wk/wv
(d, kv, dh)``, ``wo (h, dh, d)``, activations ``(B, S, H, Dh)``, so
weights cross over leaf for leaf.

The KV cache is updated in place (`_cache_write`, `_paged_decode_write`,
the paged chunk's page copy): JAX returns a new buffer, which on the card
would cost a second copy of the cache per step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.schema import LeafSpec

__all__ = ["rotary", "norm_schema", "norm_apply", "attention_schema", "attention_apply",
           "attention_decode", "attention_chunk", "mlp_schema", "mlp_apply",
           "paged_write_index"]


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


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, heads, dh) -> (B, S, heads, dh), contiguous."""
    b, s, d = x.shape
    return (x.reshape(b * s, d) @ w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, Dh) @ (H, Dh, d) -> (B, S, d)."""
    b, s, h, dh = o.shape
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
    attended; out-of-window pages may already have been recycled.
    """
    q, k, v = _qkv(params, x, cfg, pos[:, None])
    if block_tables is not None:
        k_cache = _paged_decode_write(cache["k"], k, write_at)
        v_cache = _paged_decode_write(cache["v"], v, write_at)
    else:
        k_cache = _cache_write(cache["k"], k, pos)
        v_cache = _cache_write(cache["v"], v, pos)
    out = binding["decode_attention"](q, k_cache, v_cache, pos, block_tables, window)
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
    attends only its trailing `window` keys.
    """
    c = x.shape[1]
    chunk_pos = pos + torch.arange(c, device=x.device)
    q, k, v = _qkv(params, x, cfg, chunk_pos)
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
    out = binding["chunk_attention"](q, k_cache, v_cache, pos, block_tables, window)
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


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """SiLU-GLU MLP; its width is the leaves'."""
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_in"])
    return h @ params["w_out"]
