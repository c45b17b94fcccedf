"""The flash kernel's split decode arithmetic, emulated on the CPU and held
against the JAX package.

`flash_decode_kernel` and `flash_decode_combine` (csrc/flash_attention.cu)
take every bf16 launch of one query row (decode_attention).  They cannot
run here, so `decode_emulation` repeats their arithmetic in torch: the
keys cut into splits of 128 logical positions (SPLIT, the kernel's
kSplit), fixed by position alone; a split wholly at or past kv_len, or
wholly below the window start, loads nothing and gives (m, l) = (-1e30,
0); in a live split, q (bf16) dotted with each key (bf16, a 1-byte code
decoded exactly) in fp32 (a product of two bf16 values is exact in
fp32), times scale * k_scale * log2(e), masked to -1e30 outside [window
start, kv_len); m the split's max, p = exp2(s - m) and l = sum p in fp32,
p rounded to bf16 for acc = p.V with fp32 sums (the tensor-core kernel's
rounding); then the combine in split order 0, 1, ..., n - 1, each live
split weighted by exp2(m_split - m) and an empty one skipped (its weight
is 0), acc / max(l, 1e-30), times v_scale, stored as bf16.

The emulation is held against JAX's `decode_attention_ref` and the
Pallas kernel in interpret mode within TOLS over the attention and
quantization grids' decode geometries and the kernel's own edges (bf16,
int8 and fp8 caches; contiguous and paged; full and windowed; GQA groups
of 5, 1, 2 and 18; Dh 64 and 128; positions at 0, at split and tile
boundaries and at Smax - 1, the last a parked slot); a quantized cache
also inside ATTN_ENVELOPE of the fp32 oracle on the unquantized cache.
Then the split rule's bit-identities (paged equals contiguous, W >= kv_len
equals no window, empty splits change no bit); the causal launches of one
row the kernel also takes (a 1-token prompt, windowed_attention at S = 1,
a 1-row chunk, a causal limit q_start + 1 below kv_len) against JAX; a
non-causal call that ignores an explicit q_start; chip_smoke.py's
EDGE_ROW_RTOL against a split dropped or combined twice; and the wrapper
on the CPU (no workspace, no library, no count moves).

Inputs are drawn with numpy from a crc32 seed of the case id.
"""

import importlib.util
import math
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention_ref import attention_ref as jax_attention_ref
from repro.kernels.flash_attention_ref import chunk_attention_ref as jax_chunk_ref
from repro.kernels.flash_attention_ref import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention_ref import windowed_attention_ref as jax_windowed_ref
from repro.kernels.ops import _NATIVES_INTERPRET
from repro.kernels.quant import FP8_MAX, INT8_MAX
from repro.models.layers import _quant_update as jax_quant_update
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as torch_ops
from repro_torch.kernels.flash_attention_ref import masked_attention_ref

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}          # as tests/test_torch_kernels.py
ATTN_ENVELOPE = {"int8": 0.12, "fp8": 0.30}         # as tests/test_quant_conformance.py
POISON = 50.0                                       # park-page fill
SPLIT = 128                                         # keys a split, as the kernel's kSplit
JAX_CODES = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
ROOT = Path(__file__).resolve().parents[1]


def _seed(*parts) -> int:
    return zlib.crc32(":".join(map(str, parts)).encode()) & 0x7FFFFFFF


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor with the same values (fp8
    codes by their bits)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, want, tol) -> None:
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    w = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


def decode_emulation(q, k, v, kv_len, *, block_tables=None, win_start=None, k_scale=None,
                     v_scale=None, scale=None, q_start=None, fault=None):
    """The split decode kernel's arithmetic in torch: q (B, 1, H, Dh) bf16,
    k/v (B, Sk, KV, Dh) bf16 or 1-byte codes (or page pools with
    block_tables); kv_len and win_start (B,) int; k_scale, v_scale (B,)
    float32 with a 1-byte cache; q_start (B,) int for a causal launch, whose
    one row sees keys <= q_start (the kernel's klim = min(kv_len, Sk,
    q_start + 1)).  Returns (B, 1, H, Dh) bf16.  fault: ("drop" or
    "twice", i) plants a fault, split i left out of the combine or combined
    twice."""
    assert q.dtype == torch.bfloat16 and q.shape[1] == 1
    b, _, h, dh = q.shape
    if block_tables is not None:          # the logical cache the table addresses
        k, v = (x[block_tables.long()].reshape(b, -1, *x.shape[2:]) for x in (k, v))
    sk, kvh = k.shape[1], k.shape[2]
    scale = dh ** -0.5 if scale is None else scale
    ks = torch.ones(b) if k_scale is None else k_scale.float()
    vs = torch.ones(b) if v_scale is None else v_scale.float()
    kv_len = torch.as_tensor(kv_len, dtype=torch.int64).expand(b)
    ns = max(-(-sk // SPLIT), 1)
    order = list(range(ns))
    if fault is not None:
        at = order.index(fault[1])
        order[at:at + 1] = [] if fault[0] == "drop" else [fault[1]] * 2
    out = torch.empty(b, 1, h, dh)
    for bi in range(b):
        klim = min(int(kv_len[bi]), sk)
        if q_start is not None:
            klim = min(klim, int(q_start[bi]) + 1)
        klo = 0 if win_start is None else max(int(win_start[bi]), 0)
        sc = torch.tensor(scale, dtype=torch.float32) * ks[bi] * math.log2(math.e)
        for hi in range(h):
            kv = hi // (h // kvh)
            qf = q[bi, 0, hi].float()
            parts = []                    # each split's (m, l, acc)
            for s in range(ns):
                k0 = s * SPLIT
                if k0 >= klim or k0 + SPLIT <= klo:
                    parts.append((torch.tensor(-1e30), torch.tensor(0.0), None))
                    continue
                keys = torch.arange(k0, min(k0 + SPLIT, sk))
                live = ((keys >= klo) & (keys < klim))[:, None]
                kt = torch.where(live, k[bi, k0:k0 + SPLIT, kv].float(), 0.0)
                vt = torch.where(live, v[bi, k0:k0 + SPLIT, kv].float(), 0.0)
                x = torch.where(live[:, 0], (kt @ qf) * sc, torch.tensor(-1e30))
                m = x.max()
                p = torch.exp2(x - m)
                parts.append((m, p.sum(), p.to(torch.bfloat16).float() @ vt))
            m = torch.stack([pm for pm, _, _ in parts]).max()
            l, acc = torch.tensor(0.0), torch.zeros(dh)
            for s in order:
                ms, ls, accs = parts[s]
                if ls > 0:
                    w = torch.exp2(ms - m)
                    l, acc = l + w * ls, acc + w * accs
            out[bi, 0, hi] = acc / torch.clamp(l, min=1e-30) * vs[bi]
    return out.to(torch.bfloat16)


def _paged_layout(k, v, page, seed, last, first=None):
    """Page pools of a (B, S, KV, Dh) cache on shuffled pages, the park page
    0 poisoned, and the table: blocks past each row's `last` position (and
    wholly below its `first`, when given) parked."""
    b, s = k.shape[:2]
    n = s // page
    table = np.random.default_rng(seed).permutation(np.arange(1, 1 + b * n)).reshape(b, n)
    pools = []
    for x in (k, v):
        pool = np.full((1 + b * n, page) + x.shape[2:], POISON, np.float32)
        pool[table.reshape(-1)] = x.reshape(b * n, page, *x.shape[2:])
        pools.append(pool)
    for row in range(b):
        table[row, last[row] // page + 1:] = 0
        if first is not None:
            table[row, :max(0, first[row]) // page] = 0
    return pools[0], pools[1], table.astype(np.int32)


def _win_start(pos, w, sk):
    """The wrapper's window start for one query row, ws = kv_len - W, with W
    clamped to Sk + 1 as the wrapper clamps it."""
    return torch.as_tensor(pos, dtype=torch.int64) + 1 - min(w, sk + 1)


# ---------------------------------------------------------------------------
# bf16 caches: contiguous and paged, full and windowed
# ---------------------------------------------------------------------------

# (b, smax, h, kv, dh, positions, page): the attention grid's decode
# geometries (tests/test_attention_conformance.py, page 8), then the
# kernel's: qwen's group of 5 at Dh 128 and 64 with positions at tile and
# split edges and a parked last slot (Smax - 1), a group of 1 over a
# ragged last split, a group of 5 over 2 KV heads, a group of 18 (two head
# chunks of the kernel's 16)
DECODE_GEOMS = [(2, 32, 2, 2, 8, (5, 17), 8), (1, 24, 2, 1, 8, (10,), 8),
                (3, 48, 4, 2, 16, (0, 47, 20), 8),
                (4, 384, 5, 1, 128, (0, 127, 128, 383), 32),
                (4, 384, 5, 1, 64, (63, 64, 255, 256), 16),
                (3, 320, 2, 2, 64, (0, 199, 319), 32),
                (2, 256, 10, 2, 128, (100, 255), 64),
                (1, 256, 18, 1, 64, (200,), 16)]


@pytest.mark.parametrize("window", [None, "split", "full"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("geom", DECODE_GEOMS, ids=lambda g: "x".join(map(str, g[:5])))
def test_decode_emulation_matches_jax(geom, layout, window):
    b, smax, h, kv, dh, positions, page = geom
    # a window starting inside a split (and inside a page), or one past
    # every key
    w = {None: None, "split": min(100, smax - 3), "full": smax}[window]
    seed = _seed("decode", geom)
    q, k, v = _draw(seed, (b, 1, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    pos = np.asarray(positions, np.int32)
    table = jt = tt = None
    if layout == "paged":
        first = None if w is None else pos + 1 - w
        k, v, table = _paged_layout(k, v, page, seed, pos, first)
        jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (_t(x) for x in (jq, jk, jv))
    jw = None if w is None else jnp.int32(w)
    ws = None if w is None else _win_start(pos, w, smax)
    got = decode_emulation(tq, tk, tv, torch.from_numpy(pos) + 1, block_tables=tt, win_start=ws)
    jpos = jnp.asarray(pos)
    _close(got, jax_decode_ref(jq, jk, jv, jpos, jt, jw), TOLS["bfloat16"])
    _close(got, _NATIVES_INTERPRET["decode_attention"](jq, jk, jv, jpos, jt, jw),
           TOLS["bfloat16"])
    assert torch.isfinite(got.float()).all()


# ---------------------------------------------------------------------------
# int8 and fp8 caches
# ---------------------------------------------------------------------------

def _quant_cache(x, fmt):
    """Per-row amax codes of a (B, S, KV, Dh) cache through JAX's cache
    write, with the (B,) fp32 scales (the quantization grid's recipe)."""
    top = INT8_MAX if fmt == "int8" else FP8_MAX
    s = (jnp.maximum(jnp.max(jnp.abs(x), axis=(1, 2, 3)), 1e-6) / top).astype(jnp.float32)
    return jax_quant_update(x, s, JAX_CODES[fmt]), s


# (b, smax, h, kv, dh, positions, page): the quantization grid's decode
# geometries (tests/test_torch_kvquant.py, page 8), then qwen's group of 5
# over several splits at Dh 128 and 64
QDECODE_GEOMS = [(2, 32, 2, 2, 8, (5, 17), 8), (1, 24, 2, 1, 8, (10,), 8),
                 (3, 48, 4, 2, 16, (0, 47, 20), 8),
                 (2, 384, 5, 1, 128, (128, 383), 32), (3, 256, 5, 1, 64, (0, 127, 255), 16)]


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("wtag", ["win", "full"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("geom", QDECODE_GEOMS, ids=lambda g: f"smax{g[1]}b{g[0]}dh{g[4]}")
def test_decode_emulation_quantized_matches_jax(geom, layout, wtag, fmt):
    b, smax, h, kv, dh, positions, page = geom
    w = 8 if wtag == "win" else smax
    seed = _seed("qdecode", geom, fmt)
    q, k, v = _draw(seed, (b, 1, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    pos = np.asarray(positions, np.int32)
    jq, jpos = jnp.asarray(q, jnp.bfloat16), jnp.asarray(pos)
    oracle = jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jpos, None,
                            jnp.int32(w))                       # fp32, unquantized
    (qk, ks), (qv, vs) = _quant_cache(jnp.asarray(k), fmt), _quant_cache(jnp.asarray(v), fmt)
    bt = tt = None
    if layout == "paged":
        # block i of the cache on pool page perm[i], the park page 0
        # poisoned, blocks past each row's position parked
        n = smax // page
        perm = np.random.default_rng(seed).permutation(np.arange(1, 1 + b * n))
        qk, qv = (jnp.full((1 + b * n, page) + x.shape[2:], POISON, x.dtype)
                  .at[jnp.asarray(perm)].set(x.reshape(b * n, page, *x.shape[2:]))
                  for x in (qk, qv))
        table = perm.reshape(b, n).copy()
        for row in range(b):
            table[row, pos[row] // page + 1:] = 0
        bt = jnp.asarray(table, jnp.int32)
        tt = _t(bt)
    want = jax_decode_ref(jq, qk, qv, jpos, bt, jnp.int32(w), ks, vs)
    got = decode_emulation(_t(jq), _t(qk), _t(qv), torch.from_numpy(pos) + 1, block_tables=tt,
                           win_start=_win_start(pos, w, smax), k_scale=_t(ks), v_scale=_t(vs))
    _close(got, want, TOLS["bfloat16"])
    _close(got, _NATIVES_INTERPRET["decode_attention"](jq, qk, qv, jpos, bt, jnp.int32(w), ks,
                                                       vs), TOLS["bfloat16"])
    err = float((got.float() - _t(oracle).float()).abs().max())
    assert err <= ATTN_ENVELOPE[fmt], f"{fmt}: {err:.4f} outside {ATTN_ENVELOPE[fmt]}"


# ---------------------------------------------------------------------------
# the split rule's bit-identities
# ---------------------------------------------------------------------------

def _bf16_case(tag, b=4, smax=512, h=5, kv=1, dh=64):
    q, k, v = _draw(_seed("bits", tag), (b, 1, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    return (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))


@pytest.mark.parametrize("page", [16, 32, 128])
def test_paged_equals_contiguous_bit_for_bit(page):
    """Splits are logical positions: the paged launch combines the same
    splits of the same keys as the contiguous one, whatever the page."""
    q, k, v = _bf16_case("paged")
    pos = np.array([0, 130, 300, 511], np.int32)
    pk, pv, table = _paged_layout(k.float().numpy(), v.float().numpy(), page,
                                  _seed("bits", page), pos)
    paged = decode_emulation(q, *(torch.from_numpy(x).to(torch.bfloat16) for x in (pk, pv)),
                             torch.from_numpy(pos) + 1, block_tables=torch.from_numpy(table))
    assert torch.equal(paged, decode_emulation(q, k, v, torch.from_numpy(pos) + 1))


@pytest.mark.parametrize("w", [512, 513, 4096])
def test_window_past_kv_len_equals_no_window(w):
    """W >= kv_len gives a window start <= 0: the launch is the unwindowed
    one, bit for bit."""
    q, k, v = _bf16_case("window")
    pos = np.array([0, 127, 128, 511], np.int32)
    kv_len = torch.from_numpy(pos) + 1
    assert torch.equal(decode_emulation(q, k, v, kv_len, win_start=_win_start(pos, w, 512)),
                       decode_emulation(q, k, v, kv_len))


@pytest.mark.parametrize("extra", [1, 128, 600])
def test_empty_splits_change_no_bit(extra):
    """Slots past every row's kv_len add splits that load nothing: the
    result is the same bits as over the shorter cache."""
    q, k, v = _bf16_case("empty")
    pos = np.array([5, 129, 255, 300], np.int32)
    kv_len = torch.from_numpy(pos) + 1
    pad = torch.full((4, extra, 1, 64), POISON).to(torch.bfloat16)
    longer = [torch.cat([x, pad], dim=1) for x in (k, v)]
    assert torch.equal(decode_emulation(q, *longer, kv_len), decode_emulation(q, k, v, kv_len))
    # a window that leaves the first splits empty changes no bit either
    ws = _win_start(pos, 100, 512)
    assert torch.equal(decode_emulation(q, *longer, kv_len, win_start=ws),
                       decode_emulation(q, k, v, kv_len, win_start=ws))


# ---------------------------------------------------------------------------
# causal launches of one row: a 1-token prompt, a 1-row chunk, a causal
# limit below kv_len
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["attention", "windowed_attention", "chunk_attention",
                                "chunk_attention_paged"])
def test_one_row_causal_ops_match_jax(op):
    """Every bf16 launch of one row takes the split decode kernel, causal
    ones too: `attention` on a 1-token prompt (the static diagonal, q_start
    = Sk - 1 = 0), `windowed_attention` at S = 1, and a 1-row
    `chunk_attention` at per-row positions (q_start = pos, kv_len = pos +
    1), contiguous and paged.  The emulation with the launch's q_start
    against JAX's reference and the Pallas kernel in interpret mode, and
    against the port's adapter on the CPU; a 1-row chunk equals the decode
    launch at the same positions bit for bit."""
    if op in ("attention", "windowed_attention"):
        b, h, kv, dh = 2, 5, 1, 64
        q, k, v = _draw(_seed("causal-op", op), (b, 1, h, dh), (b, 1, kv, dh), (b, 1, kv, dh))
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        tq, tk, tv = (_t(x) for x in (jq, jk, jv))
        one, zero = torch.ones(b, dtype=torch.int64), torch.zeros(b, dtype=torch.int64)
        if op == "attention":
            got = decode_emulation(tq, tk, tv, one, q_start=zero)
            want = jax_attention_ref(jq, jk, jv, causal=True)
            native = _NATIVES_INTERPRET[op](jq, jk, jv, causal=True)
            port = torch_ops._cuda_attention(tq, tk, tv, causal=True)
        else:
            # the wrapper's window start, kv_len - (min(W, Sk + Sq) + Sq - 1)
            got = decode_emulation(tq, tk, tv, one, q_start=zero, win_start=one - 2)
            want = jax_windowed_ref(jq, jk, jv, jnp.int32(4))
            native = _NATIVES_INTERPRET[op](jq, jk, jv, jnp.int32(4))
            port = torch_ops._cuda_windowed_attention(tq, tk, tv, 4)
    else:
        b, smax, h, kv, dh, page = 4, 384, 5, 1, 128, 32
        q, k, v = _draw(_seed("causal-op", op), (b, 1, h, dh), (b, smax, kv, dh),
                        (b, smax, kv, dh))
        pos = np.array([0, 127, 128, smax - 1], np.int32)
        table = jt = tt = None
        if op == "chunk_attention_paged":
            k, v, table = _paged_layout(k, v, page, _seed("causal-pool"), pos)
            jt, tt = jnp.asarray(table), torch.from_numpy(table)
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        tq, tk, tv = (_t(x) for x in (jq, jk, jv))
        tpos, jpos = torch.from_numpy(pos), jnp.asarray(pos)
        got = decode_emulation(tq, tk, tv, tpos + 1, block_tables=tt, q_start=tpos)
        assert torch.equal(got, decode_emulation(tq, tk, tv, tpos + 1, block_tables=tt))
        want = jax_chunk_ref(jq, jk, jv, jpos, jt)
        native = _NATIVES_INTERPRET["chunk_attention"](jq, jk, jv, jpos, jt)
        port = torch_ops._cuda_chunk_attention(tq, tk, tv, tpos, tt)
    _close(got, want, TOLS["bfloat16"])
    _close(got, native, TOLS["bfloat16"])
    _close(got, port, TOLS["bfloat16"])
    assert torch.isfinite(got.float()).all()


# (b, smax, h, kv, dh, q_start): per-row q_start with q_start + 1 below
# kv_len = Smax in every row, at 0, at tile and split edges and inside a
# split
CAUSAL_GEOMS = [(3, 48, 4, 2, 16, (0, 20, 46)), (4, 384, 5, 1, 128, (0, 63, 128, 300)),
                (2, 256, 10, 2, 64, (127, 200))]


@pytest.mark.parametrize("geom", CAUSAL_GEOMS, ids=lambda g: "x".join(map(str, g[:5])))
def test_causal_limit_below_kv_len_matches_jax(geom):
    """A causal launch of one row whose q_start + 1 lies below kv_len: the
    causal mask, not kv_len, ends each row's keys.  The emulation against
    the Pallas kernel in interpret mode on the same (kv_len, q_start) and
    the port's wrapper on the CPU, inside half of chip_smoke.py's
    EDGE_ROW_RTOL of the plain version, and bit for bit the launch at
    kv_len = q_start + 1; a launch that ignored the causal limit falls
    outside EDGE_ROW_RTOL."""
    b, smax, h, kv, dh, starts = geom
    q, k, v = _draw(_seed("causal", geom), (b, 1, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (_t(x) for x in (jq, jk, jv))
    qs = np.asarray(starts, np.int32)
    tqs, kv_len = torch.from_numpy(qs), torch.full((b,), smax, dtype=torch.int32)
    got = decode_emulation(tq, tk, tv, kv_len, q_start=tqs)
    want = jax_flash_attention(jq, jk, jv, jnp.full((b,), smax, jnp.int32), jnp.asarray(qs),
                               causal=True, interpret=True)
    _close(got, want, TOLS["bfloat16"])
    plain = fa.flash_attention(tq, tk, tv, kv_len, tqs, causal=True, op="chunk_attention")
    _close(got, plain, TOLS["bfloat16"])
    assert torch.equal(got, decode_emulation(tq, tk, tv, tqs + 1))
    smoke = _chip_smoke()
    assert smoke._row_rel_err(got, plain) <= smoke.EDGE_ROW_RTOL / 2
    assert smoke._row_rel_err(decode_emulation(tq, tk, tv, kv_len), plain) > smoke.EDGE_ROW_RTOL


@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("q_start", ["zero", "past", "rows"])
def test_non_causal_call_ignores_q_start(q_start, sq):
    """Only the causal mask reads q_start: the wrapper passes kv_len in its
    place for a non-causal launch, so a non-causal call with an explicit
    q_start gives the bits of the call without one, and the Pallas kernel
    in interpret mode, given the same q_start, agrees."""
    b, smax, h, kv, dh = 3, 64, 4, 2, 16
    q, k, v = _draw(_seed("non-causal", sq), (b, sq, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (_t(x) for x in (jq, jk, jv))
    lens = np.array([1, 30, 64], np.int32)
    qs = {"zero": np.zeros(b, np.int32), "past": np.full(b, 2 * smax, np.int32),
          "rows": np.array([5, 0, 40], np.int32)}[q_start]
    kv_len = torch.from_numpy(lens)
    given = fa.flash_attention(tq, tk, tv, kv_len, torch.from_numpy(qs), causal=False,
                               op="decode_attention")
    assert torch.equal(given, fa.flash_attention(tq, tk, tv, kv_len, causal=False,
                                                 op="decode_attention"))
    want = jax_flash_attention(jq, jk, jv, jnp.asarray(lens), jnp.asarray(qs), causal=False,
                               interpret=True)
    _close(given, want, TOLS["bfloat16"])
    if sq == 1:
        _close(given, decode_emulation(tq, tk, tv, kv_len), TOLS["bfloat16"])


# ---------------------------------------------------------------------------
# the row-relative limit of chip_smoke.py's decode edge cases
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (positions, dh, window, fmt): chip_smoke.py's decode edges at qwen's
# group of 5 over one KV head, Smax 2048
EDGE_GEOMS = [((0,), 128, None, None), ((63,), 128, None, None), ((64,), 64, None, None),
              ((127,), 128, None, None), ((128,), 64, None, None), ((2047,), 128, None, None),
              ((63, 128, 1500, 2047), 128, None, None), ((63, 128, 1500, 2047), 64, 200, None),
              ((63, 128, 1500, 2047), 128, None, "int8"), ((63, 128, 1500, 2047), 64, None, "fp8")]


def _edge_case(positions, dh, window, fmt):
    """(emulate(fault), plain output, the last row's first live split) of
    one edge case: bf16 q, k, v drawn from a seed (k/v as per-row amax
    codes of `fmt`), the plain version the port's fp32
    masked_attention_ref."""
    b, smax, h = len(positions), 2048, 5
    q, k, v = _draw(_seed("decode-edge", positions, dh, window, fmt), (b, 1, h, dh),
                    (b, smax, 1, dh), (b, smax, 1, dh))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    scales = {}
    if fmt is not None:
        (qk, ks), (qv, vs) = (_quant_cache(jnp.asarray(x.float().numpy()), fmt) for x in (tk, tv))
        tk, tv, scales = _t(qk), _t(qv), {"k_scale": _t(ks), "v_scale": _t(vs)}
    pos = np.asarray(positions)
    kv_len = torch.from_numpy(pos) + 1
    ws = None if window is None else _win_start(pos, window, smax)
    plain = masked_attention_ref(tq, tk, tv, kv_len, torch.zeros(b, dtype=torch.int64),
                                 causal=False, scale=dh ** -0.5, win_start=ws, **scales)
    first = 0 if window is None else max(int(ws[-1]), 0) // SPLIT
    return (lambda fault=None: decode_emulation(tq, tk, tv, kv_len, win_start=ws, fault=fault,
                                                **scales)), plain, first


@pytest.mark.parametrize("geom", EDGE_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_edge_row_limit_holds_the_emulation(geom):
    """The kernel's arithmetic stays inside EDGE_ROW_RTOL of the plain
    version at the edge cases' geometries, with room to spare."""
    smoke = _chip_smoke()
    emulate, plain, _ = _edge_case(*geom)
    rel = smoke._row_rel_err(emulate(), plain)
    assert rel <= smoke.EDGE_ROW_RTOL / 2, f"{rel:.4g} vs limit {smoke.EDGE_ROW_RTOL:.4g}"


# the last row's first live split (split 0, or the one holding its window
# start) dropped, or combined twice; a row whose only live split it is
# scales l and acc alike when it is taken twice, which changes nothing to
# find, so "twice" is planted where the row spans more than two splits
SPLIT_FAULTS = [(g, kind) for g in EDGE_GEOMS for kind in ("drop", "twice")
                if kind == "drop" or max(g[0]) >= 2 * SPLIT]


@pytest.mark.parametrize("geom, kind", SPLIT_FAULTS,
                         ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else x)
def test_edge_row_limit_catches_a_split_fault(geom, kind):
    """The last row's first live split left out of the combine, or
    combined twice, puts some row outside EDGE_ROW_RTOL."""
    smoke = _chip_smoke()
    emulate, plain, first = _edge_case(*geom)
    rel = smoke._row_rel_err(emulate((kind, first)), plain)
    assert rel > smoke.EDGE_ROW_RTOL, f"{kind} split {first}: {rel:.4g} inside the limit"


# ---------------------------------------------------------------------------
# the wrapper on the CPU: no workspace, no library, no count moves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_cpu_decode_takes_the_plain_version(monkeypatch, layout, fmt):
    """A bf16 decode on CPU tensors takes masked_attention_ref: the library
    is never built or asked for a workspace, and no launch count moves, by
    op or by (op, kernel)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the library was reached from CPU tensors")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(fa, "_workspace_floats", refuse)
    q, k, v = _draw(_seed("cpu", layout, fmt), (2, 1, 5, 64), (2, 256, 1, 64), (2, 256, 1, 64))
    pos = np.array([3, 200], np.int32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    scales = {}
    if fmt is not None:
        (qk, ks), (qv, vs) = (_quant_cache(jnp.asarray(x.float().numpy()), fmt) for x in (tk, tv))
        tk, tv, scales = _t(qk), _t(qv), {"k_scale": _t(ks), "v_scale": _t(vs)}
    table = None
    if layout == "paged":
        # the codes (or bf16 values) on shuffled pages of 64, exactly
        pk, pv, table = _paged_layout(tk.float().numpy(), tv.float().numpy(), 64,
                                      _seed("cpu-pool"), pos)
        tk, tv = (torch.from_numpy(x).to(tk.dtype) for x in (pk, pv))
        table = torch.from_numpy(table)
    _build.LAUNCHES["stub"] += 1
    _build.KERNEL_LAUNCHES["stub", "split_decode"] += 1
    before = (dict(_build.LAUNCHES), dict(_build.KERNEL_LAUNCHES))
    kv_len = torch.from_numpy(pos) + 1
    out = fa.flash_attention(tq, tk, tv, kv_len=kv_len, causal=False, block_tables=table,
                             op="decode_attention", **scales)
    assert (dict(_build.LAUNCHES), dict(_build.KERNEL_LAUNCHES)) == before
    _build.clear_launches()
    want = decode_emulation(tq, tk, tv, kv_len, block_tables=table, **scales)
    _close(out, want, TOLS["bfloat16"])


def test_split_decode_is_the_third_kernel_number():
    """The library reports the split decode kernel as kernel 2."""
    assert fa.KERNELS == ("fma", "tensor_core", "split_decode")
