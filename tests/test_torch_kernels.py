"""The port's kernel modules held against the JAX package, on the CPU.

For each op of the slice the torch reference (`rmsnorm_ref`,
`attention_ref`, `chunk_attention_ref`, `decode_attention_ref`) and the
CUDA adapter (the wrapper a card launches; on CPU tensors it takes its
plain version) get the same inputs as the JAX Pallas kernel run with
``interpret=True`` and the JAX reference, over prefill, chunk and decode
geometries with kv padding, in fp32 and bf16, within TOLS (the attention
grid's per-dtype tolerances, atol = rtol).

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
from repro.kernels.ops import _NATIVES_INTERPRET
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm_ref import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_ref import (
    attention_ref,
    chunk_attention_ref,
    decode_attention_ref,
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


@pytest.mark.parametrize("arg", ["block_tables", "window", "k_scale", "v_scale"])
def test_unported_attention_forms_raise(arg):
    q, k = torch.zeros(1, 1, 2, 8), torch.zeros(1, 4, 2, 8)
    extra = {arg: torch.zeros(1, dtype=torch.int32)}
    for fn in (decode_attention_ref, chunk_attention_ref, ops._cuda_decode_attention,
               ops._cuda_chunk_attention):
        kw = {("block_table" if arg == "block_tables" and "ref" in fn.__name__ else arg):
              extra[arg]}
        with pytest.raises(NotImplementedError):
            fn(q, k, k, 0, **kw)


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
