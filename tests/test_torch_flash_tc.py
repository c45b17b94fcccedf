"""The flash kernel's tensor-core arithmetic, emulated on the CPU and held
against the JAX package.

`flash_tc_kernel` (csrc/flash_attention.cu) takes every bf16 launch of
more than 16 query rows.  It cannot run here, so `tc_emulation` repeats
its rounding in torch: q, K and V as bf16 (1-byte codes decoded exactly),
S = q.K in fp32 (a product of two bf16 values is exact in fp32, so only
the order of the sums differs from the Pallas kernel's fp32 dot), the
score scale (times k_scale) on the fp32 S after the product, in log2
units; the -1e30 masks; an online softmax over 64-key tiles in fp32, l
summing the fp32 p; p rounded to bf16 for P.V with fp32 sums; acc / max(l,
1e-30), times v_scale, stored as bf16.  The emulation is held against
JAX's references and the Pallas kernel in interpret mode over the
attention grid's prefill, chunk, paged and windowed geometries (bf16,
within TOLS) and the quantization grid's chunks (int8/fp8 caches,
contiguous/paged, windowed/full: within TOLS of JAX's quantized reference
and inside ATTN_ENVELOPE of the fp32 oracle on the unquantized cache),
plus geometries of several 64-key tiles and more than 16 rows.

Also here: the limit chip_smoke.py holds the kernel's edge cases to row
by row (`EDGE_ROW_RTOL`), shown to hold the emulation against the plain
version at those cases' geometries and to catch a 64-key tile dropped or
counted twice; the wrapper's launch counts on the CPU (none); and
`chip_smoke._flash_by_kernel`, which reads a run's flash launches by the
kernel the library reported, on stub counts.

Inputs are drawn with numpy from a crc32 seed of the case id.
"""

import functools
import importlib.util
import math
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention_ref import attention_ref as jax_attention_ref
from repro.kernels.flash_attention_ref import chunk_attention_ref as jax_chunk_ref
from repro.kernels.flash_attention_ref import windowed_attention_ref as jax_windowed_ref
from repro.kernels.ops import _NATIVES_INTERPRET
from repro.kernels.quant import FP8_MAX, INT8_MAX
from repro.models.layers import _quant_update as jax_quant_update
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import KERNELS, flash_attention
from repro_torch.kernels.flash_attention_ref import masked_attention_ref

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}          # as tests/test_torch_kernels.py
ATTN_ENVELOPE = {"int8": 0.12, "fp8": 0.30}         # as tests/test_quant_conformance.py
POISON = 50.0                                       # park-page fill
TILE = 64                                           # keys a tile, as the kernel's kBK
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


def tc_emulation(q, k, v, kv_len, q_start, *, causal=True, block_tables=None, win_start=None,
                 k_scale=None, v_scale=None, scale=None, fault=None):
    """The tensor-core kernel's rounding in torch: q (B, Sq, H, Dh) bf16,
    k/v (B, Sk, KV, Dh) bf16 or 1-byte codes (or page pools with
    block_tables); kv_len, q_start, win_start (B,) int; k_scale, v_scale
    (B,) float32 with a 1-byte cache.  Returns (B, Sq, H, Dh) bf16.
    fault: ("drop" or "twice", i) plants a fault, key tile i left out of
    the loop or taken twice."""
    assert q.dtype == torch.bfloat16
    b, sq, h, dh = q.shape
    if block_tables is not None:          # the logical cache the table addresses
        k, v = (x[block_tables.long()].reshape(b, -1, *x.shape[2:]) for x in (k, v))
    sk, kvh = k.shape[1], k.shape[2]
    # K and V as the products read them: bf16, a 1-byte code decoded exactly
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    assert torch.equal(kb.float(), k.float()) and torch.equal(vb.float(), v.float())
    scale = dh ** -0.5 if scale is None else scale
    ks = torch.ones(b) if k_scale is None else k_scale.float()
    vs = torch.ones(b) if v_scale is None else v_scale.float()
    kv_len, q_start = (torch.as_tensor(x, dtype=torch.int64).expand(b) for x in (kv_len, q_start))
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    out = torch.empty(b, sq, h, dh)
    for bi in range(b):
        live = kpos < min(int(kv_len[bi]), sk)
        if causal:
            live = live & (kpos <= qpos + q_start[bi])
        if win_start is not None:
            live = live & (kpos >= qpos + int(win_start[bi]))
        vrow = torch.where(torch.arange(sk)[:, None, None] < kv_len[bi], vb[bi].float(), 0.0)
        sc = torch.tensor(scale, dtype=torch.float32) * ks[bi] * math.log2(math.e)
        for hi in range(h):
            kv = hi // (h // kvh)
            s = (q[bi, :, hi].float() @ kb[bi, :, kv].float().T) * sc   # fp32, log2 units
            s = torch.where(live, s, torch.tensor(-1e30))
            m = torch.full((sq,), -1e30)
            l = torch.zeros(sq)
            acc = torch.zeros(sq, dh)
            tiles = list(range(0, sk, TILE))
            if fault is not None:
                at = tiles.index(fault[1] * TILE)
                tiles[at:at + 1] = [] if fault[0] == "drop" else [tiles[at]] * 2
            for k0 in tiles:
                st = s[:, k0:k0 + TILE]
                m_new = torch.maximum(m, st.max(dim=1).values)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(st - m_new[:, None])
                l = l * alpha + p.sum(dim=1)
                acc = acc * alpha[:, None] + p.to(torch.bfloat16).float() @ vrow[k0:k0 + TILE, kv]
                m = m_new
            out[bi, :, hi] = acc / torch.clamp(l, min=1e-30)[:, None] * vs[bi]
    return out.to(torch.bfloat16)


def _bf16(*arrays):
    """Each array as (JAX bf16, torch bf16) of the same values."""
    return [(jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16))
            for a in arrays]


# ---------------------------------------------------------------------------
# whole-prompt prefill: attention and windowed_attention
# ---------------------------------------------------------------------------

# (b, sq, sk, h, kv, dh, causal): the attention grid's prefill geometries
# (tests/test_torch_kernels.py), then prompts of more than 16 rows over
# several 64-key tiles, ragged at both ends
PREFILL_GEOMS = [(2, 7, 19, 2, 1, 8, True), (1, 30, 30, 4, 2, 16, True),
                 (1, 8, 8, 2, 2, 8, False), (1, 17, 17, 2, 1, 16, True),
                 (1, 129, 129, 4, 2, 16, True), (2, 70, 200, 4, 1, 16, True),
                 (1, 40, 150, 2, 2, 16, False)]


@pytest.mark.parametrize("geom", PREFILL_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_tc_emulation_attention_matches_jax(geom):
    b, sq, sk, h, kv, dh, causal = geom
    q, k, v = _draw(_seed("tc-attn", geom), (b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q, k, v)
    got = tc_emulation(tq, tk, tv, sk, sk - sq, causal=causal)
    _close(got, jax_attention_ref(jq, jk, jv, causal=causal), TOLS["bfloat16"])
    _close(got, _NATIVES_INTERPRET["attention"](jq, jk, jv, causal=causal), TOLS["bfloat16"])
    _close(got, masked_attention_ref(tq, tk, tv, torch.full((b,), sk), torch.full((b,), sk - sq),
                                     causal=causal, scale=dh ** -0.5), TOLS["bfloat16"])


# (b, s, h, kv, dh, w)
WINDOWED_GEOMS = [(2, 30, 4, 2, 16, 8), (2, 30, 4, 2, 16, 16), (2, 30, 4, 2, 16, 30),
                  (1, 150, 2, 1, 16, 40), (1, 150, 2, 1, 16, 64)]


@pytest.mark.parametrize("geom", WINDOWED_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_tc_emulation_windowed_attention_matches_jax(geom):
    b, s, h, kv, dh, w = geom
    q, k, v = _draw(_seed("tc-win-attn", geom), (b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh))
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q, k, v)
    got = tc_emulation(tq, tk, tv, s, 0, win_start=torch.full((b,), 1 - w))
    _close(got, jax_windowed_ref(jq, jk, jv, jnp.int32(w)), TOLS["bfloat16"])
    _close(got, _NATIVES_INTERPRET["windowed_attention"](jq, jk, jv, jnp.int32(w)),
           TOLS["bfloat16"])


# ---------------------------------------------------------------------------
# chunked prefill: contiguous, paged, windowed
# ---------------------------------------------------------------------------

def _paged_layout(k, v, page, seed, last):
    """Page pools of a (B, S, KV, Dh) cache on shuffled pages, the park page
    0 poisoned, and the table: blocks past each row's `last` position
    parked."""
    b, s = k.shape[:2]
    n = s // page
    table = np.random.default_rng(seed).permutation(np.arange(1, 1 + b * n)).reshape(b, n)
    pools = []
    for x in (k, v):
        pool = np.full((1 + b * n, page) + x.shape[2:], POISON, np.float32)
        pool[table.reshape(-1)] = x.reshape(b * n, page, *x.shape[2:])
        pools.append(pool)
    table[:, last // page + 1:] = 0
    return pools[0], pools[1], table.astype(np.int32)


# (b, c, smax, h, kv, dh, pos, page): the attention grid's chunk and paged
# chunk geometries, then chunks of more than 16 rows over several tiles:
# request 0's last chunk (36 rows) and a 4-page tile at page 16
CHUNK_GEOMS = [(1, 8, 32, 4, 2, 16, 0, 8), (1, 5, 24, 2, 1, 8, 11, 8),
               (2, 8, 32, 4, 2, 16, 24, 8), (1, 8, 32, 4, 2, 16, 16, 8),
               (2, 4, 24, 2, 1, 8, 12, 4), (1, 36, 192, 4, 2, 16, 128, 16),
               (1, 17, 256, 2, 1, 16, 200, 16), (2, 64, 256, 4, 1, 16, 100, 32)]


@pytest.mark.parametrize("window", [None, "page", "2page", "full"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("geom", CHUNK_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_tc_emulation_chunk_matches_jax(geom, layout, window):
    b, c, smax, h, kv, dh, pos, page = geom
    w = {None: None, "page": page, "2page": 2 * page, "full": smax}[window]
    seed = _seed("tc-chunk", geom)
    q, k, v = _draw(seed, (b, c, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    table = jt = tt = None
    if layout == "paged":
        k, v, table = _paged_layout(k, v, page, seed, pos + c - 1)
        if w is not None:
            table[:, :max(0, pos - w) // page] = 0          # dead blocks parked
        jt, tt = jnp.asarray(table), torch.from_numpy(table)
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q, k, v)
    jw = None if w is None else jnp.int32(w)
    ws = None if w is None else torch.full((b,), pos - w + 1)   # kv_len - C - W + 1
    got = tc_emulation(tq, tk, tv, pos + c, pos, block_tables=tt, win_start=ws)
    _close(got, jax_chunk_ref(jq, jk, jv, jnp.int32(pos), jt, jw), TOLS["bfloat16"])
    _close(got, _NATIVES_INTERPRET["chunk_attention"](jq, jk, jv, jnp.int32(pos), jt, jw),
           TOLS["bfloat16"])
    assert torch.isfinite(got.float()).all()


# ---------------------------------------------------------------------------
# chunked prefill over a quantized cache
# ---------------------------------------------------------------------------

def _quant_cache(x, fmt):
    """Per-row amax codes of a (B, S, KV, Dh) cache through JAX's cache
    write, with the (B,) fp32 scales (the quantization grid's recipe)."""
    top = INT8_MAX if fmt == "int8" else FP8_MAX
    s = (jnp.maximum(jnp.max(jnp.abs(x), axis=(1, 2, 3)), 1e-6) / top).astype(jnp.float32)
    return jax_quant_update(x, s, JAX_CODES[fmt]), s


# (c, smax, h, kv, dh, pos, page): the quantization grid's chunk geometries
# (tests/test_torch_kvquant.py, page = c), then more than 16 rows over
# several tiles
QCHUNK_GEOMS = [(8, 32, 2, 2, 8, 8, 8), (16, 48, 2, 1, 8, 16, 16), (8, 24, 4, 2, 16, 0, 8),
                (36, 192, 4, 2, 16, 128, 16), (40, 256, 2, 1, 16, 90, 32)]


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("wtag", ["win", "full"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("geom", QCHUNK_GEOMS, ids=lambda g: f"c{g[0]}pos{g[5]}")
def test_tc_emulation_quantized_chunk_matches_jax(geom, layout, wtag, fmt):
    c, smax, h, kv, dh, pos, page = geom
    w = c if wtag == "win" else smax
    seed = _seed("tc-qchunk", geom, fmt)
    q, k, v = _draw(seed, (1, c, h, dh), (1, smax, kv, dh), (1, smax, kv, dh))
    jq = jnp.asarray(q, jnp.bfloat16)
    oracle = jax_chunk_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
                           None, jnp.int32(w))                    # fp32, unquantized
    (qk, ks), (qv, vs) = _quant_cache(jnp.asarray(k), fmt), _quant_cache(jnp.asarray(v), fmt)
    bt = tt = None
    if layout == "paged":
        n = smax // page
        perm = np.random.default_rng(seed).permutation(np.arange(1, 1 + n))
        bt = jnp.asarray(perm[None], jnp.int32)
        qk, qv = (jnp.full((1 + n, page) + x.shape[2:], POISON, x.dtype)
                  .at[bt.reshape(-1)].set(x.reshape(n, page, *x.shape[2:])) for x in (qk, qv))
        tt = _t(bt)
    want = jax_chunk_ref(jq, qk, qv, jnp.int32(pos), bt, jnp.int32(w), ks, vs)
    got = tc_emulation(_t(jq), _t(qk), _t(qv), pos + c, pos, block_tables=tt,
                       win_start=torch.full((1,), pos - w + 1), k_scale=_t(ks),
                       v_scale=_t(vs))
    _close(got, want, TOLS["bfloat16"])
    err = float((got.float() - _t(oracle).float()).abs().max())
    assert err <= ATTN_ENVELOPE[fmt], f"{fmt}: {err:.4f} outside {ATTN_ENVELOPE[fmt]}"


# ---------------------------------------------------------------------------
# the row-relative limit of chip_smoke.py's tensor-core edge cases
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (sq, pos, dh, fmt): chip_smoke.py's edge cases (whole prompts at pos None:
# q_start = 0, kv_len = sq; a 300-row prompt stands for its 1316), at
# qwen's GQA group of 5 query heads over one KV head
EDGE_GEOMS = [(17, None, 128, None), (300, None, 64, None), (17, 500, 128, None),
              (36, 1280, 128, None), (129, 700, 64, None), (128, 1900, 128, None),
              (17, 500, 128, "int8"), (36, 1280, 128, "fp8")]


@functools.lru_cache(maxsize=None)
def _edge_case(sq, pos, dh, fmt):
    """(emulate(fault), plain output) of one edge case: bf16 q, k, v drawn
    from a seed (k/v as per-row amax codes of `fmt`), the plain version the
    port's fp32 masked_attention_ref."""
    h, kv = 5, 1
    sk = sq if pos is None else pos + sq
    q, k, v = _draw(_seed("tc-edge", sq, pos, dh, fmt), (1, sq, h, dh), (1, sk, kv, dh),
                    (1, sk, kv, dh))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    scales = {}
    if fmt is not None:
        (qk, ks), (qv, vs) = (_quant_cache(jnp.asarray(x.float().numpy()), fmt) for x in (tk, tv))
        tk, tv, scales = _t(qk), _t(qv), {"k_scale": _t(ks).reshape(1),
                                            "v_scale": _t(vs).reshape(1)}
    kv_len, q_start = torch.tensor([sk]), torch.tensor([sk - sq])
    plain = masked_attention_ref(tq, tk, tv, kv_len, q_start, causal=True, scale=dh ** -0.5,
                                 **scales)
    return (lambda fault=None: tc_emulation(tq, tk, tv, kv_len, q_start, fault=fault,
                                            **scales)), plain


@pytest.mark.parametrize("geom", EDGE_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_edge_row_limit_holds_the_emulation(geom):
    """The kernel's rounding stays inside EDGE_ROW_RTOL of the plain version
    at the edge cases' geometries, with room to spare."""
    smoke = _chip_smoke()
    emulate, plain = _edge_case(*geom)
    rel = smoke._row_rel_err(emulate(), plain)
    assert rel <= smoke.EDGE_ROW_RTOL / 2, f"{rel:.4g} vs limit {smoke.EDGE_ROW_RTOL:.4g}"


# tile 0 dropped or taken twice; taking the only tile of a 17-key prompt
# twice scales l and acc alike, which changes nothing to find
TILE_FAULTS = [(g, kind) for g in EDGE_GEOMS for kind in ("drop", "twice")
               if kind == "drop" or g[0] + (g[1] or 0) > TILE]


@pytest.mark.parametrize("geom, kind", TILE_FAULTS,
                         ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else x)
def test_edge_row_limit_catches_a_tile_fault(geom, kind):
    """One 64-key tile left out, or taken twice, puts some row outside
    EDGE_ROW_RTOL."""
    smoke = _chip_smoke()
    emulate, plain = _edge_case(*geom)
    rel = smoke._row_rel_err(emulate((kind, 0)), plain)
    assert rel > smoke.EDGE_ROW_RTOL, f"{kind} tile 0: {rel:.4g} inside the limit"


# ---------------------------------------------------------------------------
# launches by kernel: none on the CPU, and the smoke script's split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op, sq", [("attention", 17), ("chunk_attention", 128),
                                    ("decode_attention", 1), ("windowed_attention", 40)])
def test_cpu_call_counts_no_launch(op, sq):
    """A CPU tensor takes the plain version: no count moves, by op or by
    (op, kernel); clear_launches sets both to 0."""
    q, k, v = _draw(_seed("tc-count", op), (1, sq, 2, 16), (1, 64, 1, 16), (1, 64, 1, 16))
    _build.LAUNCHES["stub"] += 1
    _build.KERNEL_LAUNCHES["stub", KERNELS[1]] += 1
    before = (dict(_build.LAUNCHES), dict(_build.KERNEL_LAUNCHES))
    out = flash_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                          kv_len=64, op=op)
    assert out.shape == (1, sq, 2, 16)
    assert (dict(_build.LAUNCHES), dict(_build.KERNEL_LAUNCHES)) == before
    _build.clear_launches()
    assert not _build.LAUNCHES and not _build.KERNEL_LAUNCHES


@pytest.mark.parametrize("op, launches, want", [
    ("chunk_attention", 59 * 48, {"tensor_core": 59 * 48, "fma": 0, "split_decode": 0}),
    ("decode_attention", 77 * 48, {"tensor_core": 0, "fma": 0, "split_decode": 77 * 48}),
    ("attention", 48, {"tensor_core": 48, "fma": 0, "split_decode": 0})])
def test_flash_launches_split_by_kernel_on_stub_counts(op, launches, want):
    """A bf16 serve run of 59 prefill steps (chunks of 128) and 77 decode
    ticks over 48 layers, and a whole-prompt prefill, as the library would
    report them."""
    smoke = _chip_smoke()
    run = {"launches": {op: launches, "rmsnorm": 97},
           "kernel_launches": {(op, k): n for k, n in want.items() if n}}
    assert smoke._flash_by_kernel(run, op) == want
    assert smoke._flash_by_kernel(run, op, max(want, key=want.get)) == want


def test_flash_launch_split_refuses_counts_it_cannot_explain():
    smoke = _chip_smoke()
    # a launch counted by op that the library did not report by kernel
    run = {"launches": {"chunk_attention": 59 * 48 + 1},
           "kernel_launches": {("chunk_attention", "tensor_core"): 59 * 48}}
    with pytest.raises(smoke.PhaseError, match="chunk_attention"):
        smoke._flash_by_kernel(run, "chunk_attention")
    # launches on a kernel the run was not to take
    run = {"launches": {"chunk_attention": 10},
           "kernel_launches": {("chunk_attention", "tensor_core"): 9,
                               ("chunk_attention", "fma"): 1}}
    assert smoke._flash_by_kernel(run, "chunk_attention") == {"tensor_core": 9, "fma": 1,
                                                               "split_decode": 0}
    with pytest.raises(smoke.PhaseError, match="not all on the tensor_core kernel"):
        smoke._flash_by_kernel(run, "chunk_attention", "tensor_core")
