"""The port's kernel modules held against the JAX package, on the CPU.

For each op of the slice the torch reference (`rmsnorm_ref`,
`attention_ref`, `windowed_attention_ref`, `chunk_attention_ref`,
`decode_attention_ref`) and the CUDA adapter (the wrapper a card
launches; on CPU tensors it takes its plain version) get the same inputs
as the JAX Pallas kernel run with ``interpret=True`` and the JAX
reference, over prefill, chunk and decode geometries with kv padding, in
fp32 and bf16, within TOLS (the attention grid's per-dtype tolerances,
atol = rtol).  The paged forms read shuffled block tables over page pools
whose park page 0 is poisoned (as tests/test_attention_conformance.py's
`_paged_layout`); the windowed forms run at W in {page, 2 page, >= kv_len}.

Inputs are drawn with numpy from a crc32 seed of the cell id and handed
to both frameworks; bf16 inputs are the same fp32 draws rounded once.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention_ref import attention_ref as jax_attention_ref
from repro.kernels.flash_attention_ref import chunk_attention_ref as jax_chunk_ref
from repro.kernels.flash_attention_ref import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention_ref import windowed_attention_ref as jax_windowed_ref
from repro.kernels.ops import _NATIVES_INTERPRET
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm_ref import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_ref import (
    attention_ref,
    chunk_attention_ref,
    decode_attention_ref,
    windowed_attention_ref,
)
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rmsnorm_ref import rmsnorm_ref

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = tuple(TOLS)


def _seed(*parts) -> int:
    return zlib.crc32(":".join(map(str, parts)).encode()) & 0x7FFFFFFF


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    return jnp.asarray(a, jnp.dtype(dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, dtype):
    tol = TOLS[dtype]
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = want.float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 128), (2, 5, 256), (1, 1, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_rmsnorm_matches_jax(shape, dtype):
    x, w = _draw(_seed("rmsnorm", shape, dtype), shape, shape[-1:])
    (jx, tx), (jw, tw) = _both(x, dtype), _both(1 + 0.1 * w, dtype)
    want_kernel = jax_rmsnorm(jx, jw, interpret=True)
    want_ref = jax_rmsnorm_ref(jx, jw)
    for got in (rmsnorm_ref(tx, tw), rmsnorm(tx, tw)):
        assert got.dtype == tx.dtype and got.shape == tx.shape
        _close(got, want_kernel, dtype)
        _close(got, want_ref, dtype)


# ---------------------------------------------------------------------------
# attention (whole-prompt prefill)
# ---------------------------------------------------------------------------

# (b, sq, sk, h, kv, dh, causal): ragged Sq < Sk, block tails, GQA groups
PREFILL_GEOMS = [(2, 7, 19, 2, 1, 8, True), (1, 30, 30, 4, 2, 16, True),
                 (1, 8, 8, 2, 2, 8, False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", PREFILL_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_attention_matches_jax(geom, dtype):
    b, sq, sk, h, kv, dh, causal = geom
    q, k, v = _draw(_seed("attention", geom, dtype),
                    (b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dtype), _both(k, dtype), _both(v, dtype)
    want_kernel = _NATIVES_INTERPRET["attention"](jq, jk, jv, causal=causal)
    want_ref = jax_attention_ref(jq, jk, jv, causal=causal)
    for got in (ops._ref_attention(tq, tk, tv, causal=causal),
                ops._cuda_attention(tq, tk, tv, causal=causal)):
        _close(got, want_kernel, dtype)
        _close(got, want_ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_chunked_reference_matches_jax(dtype):
    """The online-softmax form the op reference takes above 2k keys."""
    b, s, h, kv, dh, chunk = 1, 32, 4, 2, 16, 8
    q, k, v = _draw(_seed("chunked", dtype), (b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh))
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dtype), _both(k, dtype), _both(v, dtype)
    got = attention_ref(tq, tk, tv, causal=True, chunk_kv=chunk)
    _close(got, jax_attention_ref(jq, jk, jv, causal=True, chunk_kv=chunk), dtype)
    _close(got, attention_ref(tq, tk, tv, causal=True), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wrapper_kv_padding_matches_jax(causal, dtype):
    """The kernel wrapper's own signature: kv_len pads the tail of K/V, and
    the V rows past kv_len are poisoned (they must not reach the output)."""
    b, sq, sk, h, kv, dh, pad = 2, 7, 19, 4, 2, 8, 3
    q, k, v = _draw(_seed("flash-pad", causal, dtype),
                    (b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))
    v[:, sk - pad:] = 1e4
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dtype), _both(k, dtype), _both(v, dtype)
    want = jax_flash(jq, jk, jv, kv_len=jnp.asarray(sk - pad, jnp.int32), causal=causal,
                     block_q=8, block_k=8, interpret=True)
    got = flash_attention(tq, tk, tv, kv_len=sk - pad, causal=causal)
    _close(got, want, dtype)


# ---------------------------------------------------------------------------
# chunk_attention (chunked prefill) and decode_attention
# ---------------------------------------------------------------------------

# (b, c, smax, h, kv, dh, pos): first chunk, mid-cache, last chunk at the end
CHUNK_GEOMS = [(1, 8, 32, 4, 2, 16, 0), (1, 5, 24, 2, 1, 8, 11), (2, 8, 32, 4, 2, 16, 24)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", CHUNK_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_chunk_attention_matches_jax(geom, dtype):
    b, c, smax, h, kv, dh, pos = geom
    q, k, v = _draw(_seed("chunk", geom, dtype),
                    (b, c, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dtype), _both(k, dtype), _both(v, dtype)
    want_kernel = _NATIVES_INTERPRET["chunk_attention"](jq, jk, jv, jnp.int32(pos))
    want_ref = jax_chunk_ref(jq, jk, jv, jnp.int32(pos))
    for got in (chunk_attention_ref(tq, tk, tv, pos),
                ops._cuda_chunk_attention(tq, tk, tv, pos)):
        _close(got, want_kernel, dtype)
        _close(got, want_ref, dtype)


# (b, smax, h, kv, dh, positions): per-slot positions, the last one parked
DECODE_GEOMS = [(3, 24, 4, 2, 16, (0, 9, 23)), (4, 32, 2, 1, 8, (5, 31, 17, 31))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", DECODE_GEOMS, ids=lambda g: "x".join(map(str, g[:5])))
def test_decode_attention_matches_jax(geom, dtype):
    b, smax, h, kv, dh, positions = geom
    q, k, v = _draw(_seed("decode", geom, dtype),
                    (b, 1, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dtype), _both(k, dtype), _both(v, dtype)
    jpos = jnp.asarray(positions, jnp.int32)
    tpos = torch.tensor(positions, dtype=torch.int32)
    want_kernel = _NATIVES_INTERPRET["decode_attention"](jq, jk, jv, jpos)
    want_ref = jax_decode_ref(jq, jk, jv, jpos)
    for got in (decode_attention_ref(tq, tk, tv, tpos),
                ops._cuda_decode_attention(tq, tk, tv, tpos)):
        _close(got, want_kernel, dtype)
        _close(got, want_ref, dtype)


# ---------------------------------------------------------------------------
# paged and sliding-window forms
# ---------------------------------------------------------------------------

POISON = 50.0     # park-page fill: loud if it ever leaks into an output


def _paged_layout(k, v, page, seed):
    """Scatter a contiguous (B, S, KV, Dh) cache into page pools through a
    shuffled permutation block table; page 0 is the park page, poisoned."""
    b, s = k.shape[:2]
    n = s // page
    npages = 1 + b * n
    table = np.random.default_rng(seed).permutation(np.arange(1, npages)).reshape(b, n)
    pools = []
    for x in (k, v):
        pool = np.full((npages, page) + x.shape[2:], POISON, np.float32)
        pool[table.reshape(-1)] = x.reshape(b * n, page, *x.shape[2:])
        pools.append(pool)
    return pools[0], pools[1], table.astype(np.int32)


def _window(wtag, page, full):
    return {None: None, "page": page, "2page": 2 * page, "full": full}[wtag]


def _jax_window(w):
    return None if w is None else jnp.int32(w)


def _hold(op, q, k, v, pos, table, w, dtype):
    """The port's reference and its CUDA adapter's CPU path against the
    Pallas kernel (interpret mode) and the JAX reference, on one input."""
    jax_ref = {"decode_attention": jax_decode_ref, "chunk_attention": jax_chunk_ref}[op]
    torch_ref = {"decode_attention": decode_attention_ref,
                 "chunk_attention": chunk_attention_ref}[op]
    cuda = {"decode_attention": ops._cuda_decode_attention,
            "chunk_attention": ops._cuda_chunk_attention}[op]
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dtype), _both(k, dtype), _both(v, dtype)
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = pos if isinstance(pos, int) else torch.tensor(pos, dtype=torch.int32)
    jt = None if table is None else jnp.asarray(table)
    tt = None if table is None else torch.from_numpy(table)
    want_kernel = _NATIVES_INTERPRET[op](jq, jk, jv, jpos, jt, _jax_window(w))
    want_ref = jax_ref(jq, jk, jv, jpos, jt, _jax_window(w))
    outs = (torch_ref(tq, tk, tv, tpos, tt, w), cuda(tq, tk, tv, tpos, tt, w))
    for got in outs:
        assert torch.isfinite(got.float()).all()
        _close(got, want_kernel, dtype)
        _close(got, want_ref, dtype)
    return outs


# (b, smax, h, kv, dh, page, positions): page 4 and 8 — several pages per
# 64-key tile on the card — and a parked last slot
PAGED_DECODE_GEOMS = [(3, 24, 4, 2, 16, 8, (0, 9, 23)), (4, 32, 2, 1, 8, 4, (5, 31, 17, 31))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", PAGED_DECODE_GEOMS, ids=lambda g: "x".join(map(str, g[:6])))
def test_paged_decode_matches_jax(geom, dtype):
    b, smax, h, kv, dh, page, positions = geom
    seed = _seed("paged-decode", geom, dtype)
    q, k, v = _draw(seed, (b, 1, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    pk, pv, table = _paged_layout(k, v, page, seed)
    _hold("decode_attention", q, pk, pv, positions, table, None, dtype)


# (b, c, smax, h, kv, dh, page, pos): the chunk fills whole pages
PAGED_CHUNK_GEOMS = [(1, 8, 32, 4, 2, 16, 8, 16), (2, 4, 24, 2, 1, 8, 4, 12)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", PAGED_CHUNK_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_paged_chunk_matches_jax(geom, dtype):
    b, c, smax, h, kv, dh, page, pos = geom
    seed = _seed("paged-chunk", geom, dtype)
    q, k, v = _draw(seed, (b, c, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    pk, pv, table = _paged_layout(k, v, page, seed)
    _hold("chunk_attention", q, pk, pv, pos, table, None, dtype)


WINDOWS = ("page", "2page", "full")
PAGE = 8


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wtag", WINDOWS)
def test_windowed_decode_matches_jax(wtag, dtype):
    b, smax, h, kv, dh, positions = 3, 32, 4, 2, 16, (3, 17, 31)
    q, k, v = _draw(_seed("win-decode", wtag, dtype),
                    (b, 1, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    _hold("decode_attention", q, k, v, positions, None, _window(wtag, PAGE, smax), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wtag", WINDOWS)
def test_windowed_chunk_matches_jax(wtag, dtype):
    b, c, smax, h, kv, dh, pos = 2, 8, 32, 4, 2, 16, 20
    q, k, v = _draw(_seed("win-chunk", wtag, dtype),
                    (b, c, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    _hold("chunk_attention", q, k, v, pos, None, _window(wtag, PAGE, smax), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wtag", WINDOWS)
def test_windowed_attention_matches_jax(wtag, dtype):
    b, sq, sk, h, kv, dh = 2, 30, 30, 4, 2, 16
    q, k, v = _draw(_seed("win-attn", wtag, dtype),
                    (b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh))
    w = _window(wtag, PAGE, sk)
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dtype), _both(k, dtype), _both(v, dtype)
    want_kernel = _NATIVES_INTERPRET["windowed_attention"](jq, jk, jv, jnp.int32(w))
    want_ref = jax_windowed_ref(jq, jk, jv, jnp.int32(w))
    for got in (windowed_attention_ref(tq, tk, tv, w), ops._cuda_windowed_attention(tq, tk, tv, w),
                ops._ref_windowed_attention(tq, tk, tv, torch.tensor([w, w]))):
        _close(got, want_kernel, dtype)
        _close(got, want_ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["decode_attention", "chunk_attention"])
def test_paged_windowed_matches_jax(op, dtype):
    """Paged + windowed, with the pages wholly below every row's window
    parked on the poisoned page 0, as the scheduler's recycling leaves
    them (JAX serve.py `_slide_window`)."""
    b, smax, h, kv, dh, page, w = 2, 32, 4, 2, 16, 4, 8
    sq, pos = (1, (21, 26)) if op == "decode_attention" else (4, 24)
    seed = _seed("paged-win", op, dtype)
    q, k, v = _draw(seed, (b, sq, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    pk, pv, table = _paged_layout(k, v, page, seed)
    head = min(pos) if op == "decode_attention" else pos
    table[:, :max(0, head - w) // page] = 0          # dead blocks parked
    assert (table == 0).any()
    _hold(op, q, pk, pv, pos, table, w, dtype)


def test_paged_park_page_is_inert():
    """Park (0) entries past the written prefix are read and must be masked:
    the poisoned page never reaches the output."""
    b, smax, h, kv, dh, page, positions = 2, 32, 2, 2, 8, 8, (5, 9)
    seed = _seed("park")
    q, k, v = _draw(seed, (b, 1, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    pk, pv, table = _paged_layout(k, v, page, seed)
    table[:, 2:] = 0                                 # park everything past page 1
    _hold("decode_attention", q, pk, pv, positions, table, None, "float32")
    want = decode_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                torch.tensor(positions, dtype=torch.int32))
    _close(ops._cuda_decode_attention(*(torch.from_numpy(x) for x in (q, pk, pv)),
                                      torch.tensor(positions, dtype=torch.int32),
                                      torch.from_numpy(table)), want, "float32")


@pytest.mark.parametrize("op", ["decode_attention", "chunk_attention"])
def test_windowed_dead_pages_are_inert(op):
    """Pages wholly below the window start, parked on the poisoned page 0,
    give the output of the unparked contiguous cache."""
    b, smax, h, kv, dh, page, w = 2, 32, 2, 2, 8, 8, 8
    sq, pos = (1, (17, 20)) if op == "decode_attention" else (8, 24)
    seed = _seed("dead", op)
    q, k, v = _draw(seed, (b, sq, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    pk, pv, table = _paged_layout(k, v, page, seed)
    table[:, 0] = 0                                  # keys 0..7: below every window
    paged = _hold(op, q, pk, pv, pos, table, w, "float32")
    tpos = pos if isinstance(pos, int) else torch.tensor(pos, dtype=torch.int32)
    contiguous = (decode_attention_ref if op == "decode_attention" else chunk_attention_ref)(
        *(torch.from_numpy(x) for x in (q, k, v)), tpos, None, w)
    for got in paged:
        _close(got, contiguous, "float32")


@pytest.mark.parametrize("op", ["decode_attention", "chunk_attention", "windowed_attention"])
def test_window_past_kv_len_is_bit_identical(op):
    """W >= kv_len masks nothing: the windowed call returns exactly the
    unwindowed call's output, paged or not."""
    b, smax, h, kv, dh, page = 2, 32, 4, 2, 16, 8
    sq = {"decode_attention": 1, "chunk_attention": 8, "windowed_attention": smax}[op]
    seed = _seed("bitwise", op)
    q, k, v = _draw(seed, (b, sq, h, dh), (b, smax, kv, dh), (b, smax, kv, dh))
    tq = torch.from_numpy(q)
    if op == "windowed_attention":
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
        full = ops._cuda_attention(tq, tk, tv, causal=True)
        for w in (smax, 10 * smax):
            assert torch.equal(ops._cuda_windowed_attention(tq, tk, tv, w), full)
        return
    pk, pv, table = _paged_layout(k, v, page, seed)
    fn = ops._cuda_decode_attention if op == "decode_attention" else ops._cuda_chunk_attention
    pos = torch.tensor([7, 31], dtype=torch.int32) if sq == 1 else 16
    for args in ((torch.from_numpy(k), torch.from_numpy(v), pos, None),
                 (torch.from_numpy(pk), torch.from_numpy(pv), pos, torch.from_numpy(table))):
        full = fn(tq, *args)
        for w in (smax, 1 << 30, torch.tensor([smax, 2 * smax])):
            assert torch.equal(fn(tq, *args, w), full)


@pytest.mark.parametrize("arg", ["block_tables", "window"])
def test_paged_and_windowed_forms_run(arg):
    """The paged and windowed forms run through every entry point: the
    refs, the CUDA adapters' CPU path and the bound ops."""
    q, k = torch.ones(1, 1, 2, 8), torch.ones(1, 4, 2, 8)
    extra = {"block_tables": torch.zeros(1, 1, dtype=torch.int32),
             "window": torch.ones(1, dtype=torch.int32)}[arg]
    for fn in (decode_attention_ref, chunk_attention_ref, ops._cuda_decode_attention,
               ops._cuda_chunk_attention):
        args = (extra, None) if arg == "block_tables" else (None, extra)
        out = fn(q, k, k, 0, *args)
        assert out.shape == q.shape and torch.allclose(out, q)


def test_wrapper_checks_the_block_table_on_every_device():
    """A table the card could not read is refused before any branch."""
    q, pool = torch.zeros(2, 1, 2, 8), torch.zeros(5, 4, 2, 8)
    table = torch.ones(2, 3, dtype=torch.int32)
    assert flash_attention(q, pool, pool, block_tables=table).shape == q.shape
    with pytest.raises(TypeError, match="int32"):
        flash_attention(q, pool, pool, block_tables=table.long())
    with pytest.raises(ValueError, match="batch"):
        flash_attention(q, pool, pool, block_tables=table[:1])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, pool, pool, block_tables=torch.ones(3, 2, dtype=torch.int32).T)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, pool, pool[:, :, :1], block_tables=table)


def test_cpu_wrappers_never_build_or_count():
    """On CPU tensors the wrappers take their plain versions: nothing is
    built and no launch is counted."""
    before = dict(_build.LAUNCHES)
    x = torch.ones(2, 8)
    rmsnorm(x, torch.ones(8))
    flash_attention(torch.ones(1, 2, 2, 8), torch.ones(1, 2, 2, 8), torch.ones(1, 2, 2, 8))
    assert dict(_build.LAUNCHES) == before
    assert _build._lib is None


def test_wrappers_check_the_kernel_layout_on_every_device():
    """Layout faults the card would refuse are refused on the CPU too."""
    w = torch.ones(8)
    with pytest.raises(ValueError, match="16-byte"):
        rmsnorm(torch.zeros(65)[1:].view(8, 8), w)          # base off by 4 bytes
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(torch.zeros(8, 16)[:, ::2], w)
    q = torch.zeros(1, 2, 2, 8)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, torch.zeros(1, 2, 8, 2).transpose(2, 3), q)
    with pytest.raises(TypeError, match="float16"):
        rmsnorm(torch.zeros(2, 8, dtype=torch.float16), w.half())
