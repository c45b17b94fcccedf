"""The port's quantized KV cache held against the JAX package, on the CPU.

  * the op: the quantization grid of tests/test_quant_conformance.py
    (decode and chunk attention, geometry x contiguous/paged x windowed/full
    x int8/fp8) through the port's `decode_attention_ref` /
    `chunk_attention_ref` and the CUDA adapters (on CPU tensors, the
    flash wrapper's plain version), against JAX's references and the
    Pallas kernel in interpret mode on the same codes and scales, within
    5 x 2e-5, and inside ATTN_ENVELOPE of the fp32 oracle on the
    unquantized cache; W >= kv_len bit-identical to no window; bf16 q;
    the park page inert; () scales equal to (B,) rows; a lone scale, a
    1-byte cache without scales, or scales on a full-precision cache
    refused;
  * the cache write: `quant_update` gives JAX's `_quant_update` codes bit
    for bit, int8 and fp8, at zero, at the clip, past it and at rounding
    ties;
  * the model: `Model(kv_quantize=)` has JAX's cache layout and
    calibration; the reduced qwen2.5-14b (fp32) gives JAX's whole-prompt
    logits and quantized cache (bit for bit), and its chunked prefill and
    decode logits, over contiguous and paged caches;
  * serving: `Server`/`TorchEngine(quantize=)` gives the JAX engine's
    greedy tokens, int8 and fp8, contiguous and paged; a quantized paged
    slot exported by either framework continues in the other; the CLI
    serves with ``--quantize``.

Inputs are drawn with numpy from a crc32 seed of the case id.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manifest import quantize_tree as jax_quantize_tree
from repro.configs import get_config as jax_get_config
from repro.core import Runtime as JaxRuntime
from repro.core.platform import POD_SIM
from repro.kernels.flash_attention_ref import chunk_attention_ref as jax_chunk_ref
from repro.kernels.flash_attention_ref import decode_attention_ref as jax_decode_ref
from repro.kernels.ops import _NATIVES_INTERPRET
from repro.kernels.ops import register_all as jax_register_all
from repro.kernels.quant import FP8_MAX, INT8_MAX
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import Scheduler as JaxScheduler
from repro.launch.serve import Server as JaxServer
from repro.launch.train import make_bundle as jax_make_bundle
from repro.models import model as jax_model_mod
from repro.models.layers import _quant_update as jax_quant_update
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.convert import _to_torch, params_from_jax
from repro_torch.core.runtime import Runtime
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_ref import chunk_attention_ref, decode_attention_ref
from repro_torch.kernels.ops import _NATIVES as TORCH_NATIVES
from repro_torch.kernels.ops import PORTED_OPS
from repro_torch.launch.bundle import make_bundle
from repro_torch.launch.serve import Request, Scheduler, Server, TorchEngine
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import model as torch_model_mod
from repro_torch.models.layers import quant_update
from repro_torch.models.model import Model

ARCH = "qwen2.5-14b"
MAMBA = "mamba2-780m"
FORMATS = ("int8", "fp8")
TOL = 2e-5                  # the quantization grid's fp32 tolerance
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
ATTN_ENVELOPE = {"int8": 0.12, "fp8": 0.30}   # as tests/test_quant_conformance.py
POISON = 50.0               # park-page fill
MODEL_TOL = 1e-4            # of the largest logit
SLOTS, MAX_LEN, CHUNK = 3, 32, 5
JAX_CODES = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
TORCH_CODES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _seed(*parts) -> int:
    return zlib.crc32(":".join(map(str, parts)).encode()) & 0x7FFFFFFF


def _bits(a) -> np.ndarray:
    """Raw bits of a JAX array, numpy array or torch tensor (fp8 has no
    numpy dtype of torch's), for a bit-for-bit comparison."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy() if a.dtype == torch.float8_e4m3fn else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _same(got, want) -> None:
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
    np.testing.assert_array_equal(g, w)


def _codes_agree(got, want) -> None:
    """Codes written from k/v that the two frameworks computed apart by
    fp32 rounding: equal but where a value sat on a rounding boundary, and
    there one code apart (adjacent fp8 codes of one sign differ by 1 in
    their bits), in at most 1 element of 1000."""
    g, w = _bits(got).astype(np.int16), _bits(want).astype(np.int16)
    assert g.shape == w.shape
    d = np.abs(g - w)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (int(d.max()), float((d > 0).mean()))


def _t(a) -> torch.Tensor:
    """A JAX array as a torch tensor with the same bits."""
    return _to_torch(np.asarray(a))


def _np32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(got, want, scale=5, tol=TOL) -> None:
    np.testing.assert_allclose(_np32(got), _np32(want), atol=scale * tol, rtol=scale * tol)


def _envelope(got, want, fmt) -> None:
    err = float(np.max(np.abs(_np32(got) - _np32(want))))
    assert err <= ATTN_ENVELOPE[fmt], f"{fmt}: {err:.4f} outside {ATTN_ENVELOPE[fmt]}"


# ---------------------------------------------------------------------------
# the op: the quantization grid, on the port
# ---------------------------------------------------------------------------

def _quant_cache(x: jnp.ndarray, fmt: str):
    """Per-row amax codes of a (B, S, KV, Dh) cache through JAX's cache
    write, with the (B,) fp32 scales (the grid's recipe)."""
    top = INT8_MAX if fmt == "int8" else FP8_MAX
    s = (jnp.maximum(jnp.max(jnp.abs(x), axis=(1, 2, 3)), 1e-6) / top).astype(jnp.float32)
    return jax_quant_update(x, s, JAX_CODES[fmt]), s


def _paged_layout(k, v, page, seed):
    """Shuffled page pools of the codes, park page 0 poisoned."""
    b, s = k.shape[:2]
    n = s // page
    npages = 1 + b * n
    perm = np.random.default_rng(seed).permutation(np.arange(1, npages))
    bt = jnp.asarray(perm.reshape(b, n), jnp.int32)
    pools = []
    for x in (k, v):
        pool = jnp.full((npages, page) + x.shape[2:], POISON, x.dtype)
        pools.append(pool.at[bt.reshape(-1)].set(x.reshape(b * n, page, *x.shape[2:])))
    return pools[0], pools[1], bt


def _whole_vectors(dh: int) -> bool:
    """Whether a 1-byte cache row of Dh codes is whole 16-byte vectors, as
    the flash wrapper requires on every device."""
    return dh % 16 == 0


# (b, smax, h, kv, dh, pos), as tests/test_quant_conformance.py
DECODE_GEOMS = [
    (2, 32, 2, 2, 8, (5, 17)),
    (1, 24, 2, 1, 8, 10),
    (3, 48, 4, 2, 16, (0, 47, 20)),
]
# (c, smax, h, kv, dh, pos)
CHUNK_GEOMS = [
    (8, 32, 2, 2, 8, 8),
    (16, 48, 2, 1, 8, 16),
    (8, 24, 4, 2, 16, 0),
]


def _draws(tag, geom, fmt, b, sq):
    _, smax, h, kv, dh, _ = geom
    rng = np.random.default_rng(_seed(tag, geom, fmt))
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, sq, h, dh), (b, smax, kv, dh), (b, smax, kv, dh)))
    return jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)


def _run_grid(op, q, k, v, pos, tpos, w, wmax, layout, fmt, page, seed):
    """One grid cell: JAX's ref and Pallas kernel, the port's ref and CUDA
    adapter on the same codes; returns nothing, asserts everything."""
    jax_ref, torch_ref = {"decode": (jax_decode_ref, decode_attention_ref),
                          "chunk": (jax_chunk_ref, chunk_attention_ref)}[op]
    adapter = {"decode": ops._cuda_decode_attention, "chunk": ops._cuda_chunk_attention}[op]
    pallas = _NATIVES_INTERPRET[f"{op}_attention"]
    want = jax_ref(q, k, v, pos, None, jnp.int32(w))        # fp32 oracle
    qk, ks = _quant_cache(k, fmt)
    qv, vs = _quant_cache(v, fmt)
    if layout == "paged":
        qk, qv, bt = _paged_layout(qk, qv, page, seed)
        tbt = _t(bt)
    else:
        bt, tbt = None, None
    jw, tw = jnp.int32(w), torch.tensor(w, dtype=torch.int32)
    qref = jax_ref(q, qk, qv, pos, bt, jw, ks, vs)
    kern = pallas(q, qk, qv, pos, bt, jw, ks, vs)
    _close(kern, qref)
    tq, tk, tv, tks, tvs = _t(q), _t(qk), _t(qv), _t(ks), _t(vs)
    assert tk.dtype == TORCH_CODES[fmt]
    ours = torch_ref(tq, tk, tv, tpos, tbt, tw, tks, tvs)
    _close(ours, qref)
    _close(ours, kern)
    _envelope(ours, want, fmt)
    if not _whole_vectors(q.shape[-1]):
        with pytest.raises(ValueError, match="16-byte"):
            adapter(tq, tk, tv, tpos, tbt, tw, tks, tvs)
        return
    wrapped = adapter(tq, tk, tv, tpos, tbt, tw, tks, tvs)
    _close(wrapped, qref)
    _envelope(wrapped, want, fmt)
    if w >= wmax:     # a window past every key: the unwindowed result, bit for bit
        assert torch.equal(wrapped, adapter(tq, tk, tv, tpos, tbt, None, tks, tvs))
        assert torch.equal(ours, torch_ref(tq, tk, tv, tpos, tbt, None, tks, tvs))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("wtag", ["win", "full"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("geom", DECODE_GEOMS, ids=lambda g: f"smax{g[1]}b{g[0]}")
def test_quant_decode_grid_matches_jax(geom, layout, wtag, fmt):
    b, smax, pos = geom[0], geom[1], geom[5]
    q, k, v = _draws("qdecode", geom, fmt, b, 1)
    w = 8 if wtag == "win" else smax
    _run_grid("decode", q, k, v, jnp.asarray(pos, jnp.int32),
              torch.tensor(pos, dtype=torch.int32), w, smax, layout, fmt, 8,
              _seed("qdecode", geom, fmt, "pool"))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("wtag", ["win", "full"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("geom", CHUNK_GEOMS, ids=lambda g: f"c{g[0]}pos{g[5]}")
def test_quant_chunk_grid_matches_jax(geom, layout, wtag, fmt):
    c, smax, pos = geom[0], geom[1], geom[5]
    q, k, v = _draws("qchunk", geom, fmt, 1, c)
    w = c if wtag == "win" else smax
    _run_grid("chunk", q, k, v, pos, pos, w, smax, layout, fmt, c,
              _seed("qchunk", geom, fmt, "pool"))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("op", ["decode", "chunk"])
def test_quant_attention_takes_bf16_queries(op, fmt):
    """A bf16 q against a quantized cache computes in fp32 after the scale
    (JAX's promotion): the port's ref and adapter give JAX's ref within
    the bf16 tolerance, in bf16."""
    b, sq, pos = (3, 1, (4, 40, 63)) if op == "decode" else (1, 16, 32)
    rng = np.random.default_rng(_seed("bf16q", op, fmt))
    q = rng.standard_normal((b, sq, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((b, 64, 2, 64)).astype(np.float32) for _ in range(2))
    qk, ks = _quant_cache(jnp.asarray(k), fmt)
    qv, vs = _quant_cache(jnp.asarray(v), fmt)
    jq = jnp.asarray(q, jnp.bfloat16)
    jax_ref = jax_decode_ref if op == "decode" else jax_chunk_ref
    jpos = jnp.asarray(pos, jnp.int32)
    want = jax_ref(jq, qk, qv, jpos, None, None, ks, vs)
    assert want.dtype == jnp.bfloat16
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tpos = torch.tensor(pos, dtype=torch.int32)
    ref = decode_attention_ref if op == "decode" else chunk_attention_ref
    adapter = ops._cuda_decode_attention if op == "decode" else ops._cuda_chunk_attention
    for fn in (ref, adapter):
        got = fn(tq, _t(qk), _t(qv), tpos, None, None, _t(ks), _t(vs))
        assert got.dtype == torch.bfloat16
        _close(got, want, scale=1, tol=TOLS["bfloat16"])


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_paged_equals_contiguous_on_the_same_codes(fmt):
    geom = DECODE_GEOMS[2]
    q, k, v = _draws("qd-layout", geom, fmt, geom[0], 1)
    qk, ks = _quant_cache(k, fmt)
    qv, vs = _quant_cache(v, fmt)
    pk, pv, bt = _paged_layout(qk, qv, 8, _seed("qd-layout", fmt))
    pos = torch.tensor(geom[5], dtype=torch.int32)
    cont = ops._cuda_decode_attention(_t(q), _t(qk), _t(qv), pos, None, None, _t(ks), _t(vs))
    paged = ops._cuda_decode_attention(_t(q), _t(pk), _t(pv), pos, _t(bt), None, _t(ks), _t(vs))
    _close(paged, cont)


def test_quant_park_page_is_inert():
    """Blocks past the written prefix parked on the poisoned page stay
    unobservable through the quantized path."""
    geom = (2, 32, 2, 2, 16, (5, 9))
    q, k, v = _draws("qpark", geom, "int8", 2, 1)
    qk, ks = _quant_cache(k, "int8")
    qv, vs = _quant_cache(v, "int8")
    pk, pv, bt = _paged_layout(qk, qv, 8, _seed("qpark", "pool"))
    bt = bt.at[:, 2:].set(0)                     # park everything past page 1
    pos = torch.tensor(geom[5], dtype=torch.int32)
    want = jax_decode_ref(q, k, v, jnp.asarray(geom[5], jnp.int32))
    for fn in (decode_attention_ref, ops._cuda_decode_attention):
        out = fn(_t(q), _t(pk), _t(pv), pos, _t(bt), None, _t(ks), _t(vs))
        assert bool(torch.isfinite(out).all())
        _envelope(out, want, "int8")


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_scalar_scale_equals_the_row_of_scales(fmt):
    q, k, v = _draws("qscalar", DECODE_GEOMS[2], fmt, 3, 1)
    qk, _ = _quant_cache(k, fmt)
    qv, _ = _quant_cache(v, fmt)
    pos = torch.tensor((0, 47, 20), dtype=torch.int32)
    row = torch.full((3,), 0.03)
    for fn in (decode_attention_ref, ops._cuda_decode_attention):
        a = fn(_t(q), _t(qk), _t(qv), pos, None, None, torch.tensor(0.03), torch.tensor(0.03))
        b = fn(_t(q), _t(qk), _t(qv), pos, None, None, row, row)
        _close(a, b)


@pytest.mark.parametrize("case", ["k_scale alone", "v_scale alone", "codes without scales"])
@pytest.mark.parametrize("fn", [decode_attention_ref, chunk_attention_ref,
                                ops._cuda_decode_attention, ops._cuda_chunk_attention],
                         ids=["decode_ref", "chunk_ref", "cuda_decode", "cuda_chunk"])
def test_a_lone_scale_or_a_quantized_cache_without_scales_raises(fn, case):
    q = torch.zeros(1, 1, 2, 16)
    codes = torch.zeros(1, 4, 2, 16, dtype=torch.int8)
    one = torch.ones(1)
    args = {"k_scale alone": (codes, one, None), "v_scale alone": (codes, None, one),
            "codes without scales": (codes, None, None)}[case]
    with pytest.raises(ValueError, match="scale"):
        fn(q, args[0], args[0], 0, None, None, args[1], args[2])


@pytest.mark.parametrize("bad", ["full-precision cache", "mixed formats", "scale dtype",
                                 "scale shape"])
def test_flash_wrapper_checks_the_quantized_form(bad):
    q = torch.zeros(2, 1, 2, 16)
    k8 = torch.zeros(2, 4, 2, 16, dtype=torch.int8)
    kf = k8.to(torch.float8_e4m3fn)
    row = torch.ones(2)
    args = {"full-precision cache": (torch.zeros(2, 4, 2, 16),) * 2 + (row, row),
            "mixed formats": (k8, kf, row, row),
            "scale dtype": (k8, k8, row.double(), row),
            "scale shape": (k8, k8, torch.ones(3), row)}[bad]
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, args[0], args[1], k_scale=args[2], v_scale=args[3])


# ---------------------------------------------------------------------------
# the cache write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_update_is_bit_identical_to_jax(dtype, fmt):
    """Normal draws plus zeros, the clip, values past it and half-way
    points between codes, with a (B,) and a () scale."""
    top = INT8_MAX if fmt == "int8" else FP8_MAX
    s = np.array([0.05, 0.013], np.float32)
    rng = np.random.default_rng(_seed("qupd", dtype, fmt))
    x = rng.standard_normal((2, 6, 2, 16)).astype(np.float32) * 3
    x[:, 0] = 0.0
    x[:, 1, 0] = top * s[:, None]                                # at the clip
    x[:, 1, 1] = -3 * top * s[:, None]                           # past it
    x[:, 2] = (np.arange(32).reshape(2, 16) - 16.5)[None] * s[:, None, None]   # ties
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for scale in (s, s[0]):
        want = jax_quant_update(jx, jnp.asarray(scale), JAX_CODES[fmt])
        got = quant_update(tx, torch.from_numpy(np.asarray(scale)), TORCH_CODES[fmt])
        _same(got, want)
        assert float(got.float().abs().max()) == top


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_calibration_and_cache_layout_equal_jax(fmt):
    """The copied KV_CALIBRATION_AMAX, the scale it gives, and the
    contiguous and paged cache layouts and initial values."""
    assert torch_model_mod.KV_CALIBRATION_AMAX == jax_model_mod.KV_CALIBRATION_AMAX
    tm = Model(get_config(ARCH).reduced(), {}, device="cpu", kv_quantize=fmt)
    jm = JaxModel(jax_get_config(ARCH).reduced(), kv_quantize=fmt)
    assert tm.kv_scale_init == jm.kv_scale_init
    for ours, theirs in ((tm.cache_shapes(3, 8), jm.cache_shapes(3, 8)),
                         (tm.paged_cache_shapes(9, 4, 3), jm.paged_cache_shapes(9, 4, 3))):
        assert {n: (tuple(s), str(d)) for n, (s, d) in ours["p0"].items()} \
            == {n: (tuple(s), str(d)) for n, (s, d) in theirs["p0"].items()}
    for ours, theirs in ((tm.init_cache(3, 8), jm.init_cache(3, 8)),
                         (tm.init_paged_cache(9, 4, 3), jm.init_paged_cache(9, 4, 3))):
        for name in ("k", "v", "k_scale", "v_scale"):
            _same(ours["p0"][name], theirs["p0"][name])


def test_model_refuses_what_has_no_quantized_cache():
    with pytest.raises(ValueError, match="kv_quantize"):
        Model(get_config(ARCH).reduced(), {}, device="cpu", kv_quantize="int4")
    with pytest.raises(ValueError, match="no KV cache"):
        Model(get_config(MAMBA).reduced(), {}, device="cpu", kv_quantize="int8")


@pytest.fixture(scope="module")
def jax_params():
    return JaxModel(jax_get_config(ARCH).reduced()).init(jax.random.PRNGKey(0))


def _pair(jax_params, fmt, kernels):
    """JAX's and the port's reduced qwen with a `fmt` cache on the same
    full-precision weights: references, or kernels (Pallas in interpret
    mode; the CUDA adapters' plain versions)."""
    cfg = get_config(ARCH).reduced()
    if kernels:
        from repro.core.registry import OpRegistry as JaxRegistry

        reg = jax_register_all(JaxRegistry())
        jbinding = reg.bind(reg.declared(), POD_SIM, native=True, freeze=False)
        tbinding = {op: TORCH_NATIVES[op] for op in PORTED_OPS}
    else:
        rt = Runtime(host_env={})
        jbinding, tbinding = None, rt.deploy(make_bundle(ARCH, reduced=True),
                                             device="cpu").binding
        rt.cleanup()
    jm = JaxModel(jax_get_config(ARCH).reduced(), binding=jbinding, kv_quantize=fmt)
    tm = Model(cfg, tbinding, device="cpu", kv_quantize=fmt).load_params(
        params_from_jax(jax.tree.map(np.asarray, jax_params), cfg))
    return jm, tm


def _close_logits(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=MODEL_TOL * float(np.abs(want).max()),
                               rtol=0)


@pytest.mark.parametrize("kernels", [False, True], ids=["refs", "kernels"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_whole_prompt_prefill_and_its_quantized_cache_match_jax(jax_params, fmt, kernels):
    jm, tm = _pair(jax_params, fmt, kernels)
    tokens = np.random.default_rng(_seed("kvprefill", fmt, kernels)).integers(0, 256, (2, 11))
    jl, jcache = jax.jit(jm.prefill)(jax_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, tcache = tm.prefill({"tokens": torch.from_numpy(tokens)})
    _close_logits(tl, jl)
    assert tcache["p0"]["k"].dtype == TORCH_CODES[fmt]
    assert set(tcache["p0"]) == set(jcache["p0"]) == {"k", "v", "k_scale", "v_scale"}
    for name in tcache["p0"]:
        _same(tcache["p0"][name], jcache["p0"][name])


def _tables(rng, num_pages):
    """Shuffled tables for slots 0 and 1; slot 2 parked (all zeros)."""
    nblocks = -(-MAX_LEN // CHUNK)
    ids = rng.permutation(np.arange(1, num_pages))[:2 * nblocks].reshape(2, nblocks)
    return np.concatenate([ids, np.zeros((1, nblocks), np.int64)]).astype(np.int32)


@pytest.mark.parametrize("kernels", [False, True], ids=["refs", "kernels"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_chunked_prefill_and_decode_over_a_quantized_cache_match_jax(jax_params, fmt, layout,
                                                                     kernels):
    """prefill_into 5 + 5 + 3 tokens into slot 1, then two decode ticks
    with slot 2 parked: logits within 1e-4 of the largest, the codes
    written JAX's (`_codes_agree`: the projections the two frameworks
    quantize differ by fp32 rounding) and the scale rows JAX's."""
    jm, tm = _pair(jax_params, fmt, kernels)
    rng = np.random.default_rng(_seed("kvsteps", fmt, layout, kernels))
    if layout == "paged":
        num_pages = 1 + SLOTS * -(-MAX_LEN // CHUNK)
        jcache = jm.init_paged_cache(num_pages, CHUNK, SLOTS)
        tcache = tm.init_paged_cache(num_pages, CHUNK, SLOTS)
        tables = _tables(rng, num_pages)
    else:
        jcache, tcache, tables = jm.init_cache(SLOTS, MAX_LEN), tm.init_cache(SLOTS, MAX_LEN), None
    prompt = rng.integers(0, 256, 13)
    step, slot = jax.jit(jm.prefill_into), 1
    for start in range(0, len(prompt), CHUNK):
        n = min(CHUNK, len(prompt) - start)
        buf = np.zeros((1, CHUNK), np.int32)
        buf[0, :n] = prompt[start:start + n]
        kw = {} if tables is None else {"block_row": jnp.asarray(tables[slot])}
        jl, jcache = step(jax_params, jnp.asarray(buf), jcache, jnp.int32(slot),
                          jnp.int32(start), jnp.int32(n), **kw)
        tl, tcache = tm.prefill_into(torch.from_numpy(buf), tcache, slot, start, n,
                                     block_row=None if tables is None else tables[slot])
        _close_logits(tl, jl)
    pos = np.array([4, len(prompt), MAX_LEN - 1], np.int32)
    active = np.array([True, True, False])
    decode = jax.jit(jm.decode)
    for _ in range(2):
        token = rng.integers(0, 256, (SLOTS, 1)).astype(np.int32)
        jl, jcache = decode(jax_params, jnp.asarray(token), jcache, jnp.asarray(pos),
                            jnp.asarray(active), None if tables is None else jnp.asarray(tables))
        tl, tcache = tm.decode(torch.from_numpy(token), tcache, torch.from_numpy(pos), active,
                               block_tables=tables)
        _close_logits(tl[:2], jl[:2])
        pos = pos + active
    assert tcache["p0"]["k"].dtype == TORCH_CODES[fmt]
    for name in ("k", "v"):
        _codes_agree(tcache["p0"][name], jcache["p0"][name])
    for name in ("k_scale", "v_scale"):
        _same(tcache["p0"][name], jcache["p0"][name])


def test_slot_export_carries_the_scale_rows_and_fp8_as_float32():
    """A quantized slot exports its scale rows as JAX's does, fp8 codes as
    float32 (exact), and imports back to the same bits."""
    tm = Model(get_config(ARCH).reduced(), {}, device="cpu", kv_quantize="fp8")
    cache = tm.init_paged_cache(9, 4, 2)
    rng = np.random.default_rng(_seed("fp8-export"))
    for name in ("k", "v"):
        cache["p0"][name].copy_(torch.from_numpy(rng.standard_normal((2, 9, 4, 2, 16))
                                                 .astype(np.float32) * 100))
    arrays = tm.export_paged_slot(cache, [7, 2, 5], 1)
    assert set(arrays) == {"p0/k", "p0/v", "p0/k_scale", "p0/v_scale"}
    assert arrays["p0/k"].dtype == np.float32 and arrays["p0/k_scale"].shape == (2,)
    again = tm.init_paged_cache(9, 4, 2)
    tm.import_paged_slot(again, arrays, [1, 3, 8], 0)
    _same(again["p0"]["k"][:, [1, 3, 8]], cache["p0"]["k"][:, [7, 2, 5]])
    _same(again["p0"]["k_scale"][:, 0], cache["p0"]["k_scale"][:, 1])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_container():
    rt = JaxRuntime()
    container = rt.deploy(jax_make_bundle(ARCH, reduced=True), mesh=make_host_mesh(data=1))
    yield container
    rt.cleanup()


@pytest.fixture()
def torch_container():
    rt = Runtime(host_env={})
    yield rt.deploy(make_bundle(ARCH, reduced=True), device="cpu")
    rt.cleanup()


def _requests(cls, seed, n=5):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 256, int(rng.integers(2, 21))).astype(np.int32),
                max_new=int(rng.integers(2, 7))) for i in range(n)]


def _serve(server, cls, seed, n=5):
    for r in _requests(cls, seed, n):
        assert server.submit(r)
    server.run()
    return [r.tokens for r in server.requests]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantized_server_gives_the_jax_tokens(jax_container, torch_container, fmt, paged):
    """The JAX engine's quantize= (its weights drawn and quantized, its
    cache quantized) against the port's on the same storage-form tree."""
    kw = dict(slots=2, max_len=48, chunk=8, paged=paged, quantize=fmt)
    jserver = JaxServer(jax_get_config(ARCH).reduced(), jax_container, **kw)
    tserver = Server(get_config(ARCH).reduced(), torch_container, device="cpu",
                     params=jax.tree.map(np.asarray, jserver.engine.params), **kw)
    assert tserver.engine.cache["p0"]["k"].dtype == TORCH_CODES[fmt]
    assert tserver.engine.model.layers[0].mlp["w_in"]["q"].dtype == TORCH_CODES[fmt]
    seed = _seed("kvserve", fmt, paged)
    assert _serve(tserver, Request, seed) == _serve(jserver, JaxRequest, seed)
    assert tserver.engine.decode_calls == jserver.engine.decode_calls


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_takes_a_full_precision_tree_and_refuses_other_codes(jax_container,
                                                                      torch_container, fmt):
    """A full-precision tree goes through the port's quantize_tree: the
    tokens are the JAX engine's, which quantizes the same draws.  A tree
    whose codes are of the other format is refused."""
    kw = dict(slots=2, max_len=48, chunk=8, quantize=fmt)
    jserver = JaxServer(jax_get_config(ARCH).reduced(), jax_container, **kw)
    full = JaxModel(jax_get_config(ARCH).reduced()).init(jax.random.PRNGKey(0))
    tserver = Server(get_config(ARCH).reduced(), torch_container, device="cpu",
                     params=jax.tree.map(np.asarray, full), **kw)
    seed = _seed("kvserve-full", fmt)
    assert _serve(tserver, Request, seed) == _serve(jserver, JaxRequest, seed)
    other = "fp8" if fmt == "int8" else "int8"
    with pytest.raises(ValueError, match="codes"):
        TorchEngine(get_config(ARCH).reduced(), torch_container, slots=1, max_len=16,
                    device="cpu", quantize=fmt,
                    params=jax.tree.map(np.asarray, jax_quantize_tree(full, other)))


@pytest.mark.parametrize("quantize", ["int4", "none"])
def test_engine_quantize_option_values(torch_container, quantize):
    """'none' is no quantization, as in the JAX engine; other names are
    refused as there."""
    kw = dict(slots=1, max_len=16, device="cpu", quantize=quantize)
    if quantize == "none":
        eng = TorchEngine(get_config(ARCH).reduced(), torch_container, **kw)
        assert eng.quantize is None and eng.cache["p0"]["k"].dtype == torch.float32
    else:
        with pytest.raises(ValueError, match="int8/fp8/none"):
            TorchEngine(get_config(ARCH).reduced(), torch_container, **kw)


def _drain(sched, max_ticks=10_000):
    while not sched.idle:
        sched.tick()
        max_ticks -= 1
        assert max_ticks > 0, "scheduler failed to drain"


def _handoff(src_engine, src_sched, src_cls, dst_engine, dst_sched, dst_cls, seed):
    """Prefill on the source engine, export each slot after its first
    token, adopt and import it into the destination and decode there;
    returns the tokens."""
    handoffs = []

    def export(req):
        arrays, pages_used = src_engine.export_slot(req.slot, req.next_pos)
        assert {"p0/k_scale", "p0/v_scale"} <= set(arrays)
        handoffs.append((req, arrays, pages_used))

    src = src_sched(src_engine, on_handoff=export)
    reqs = _requests(src_cls, seed, n=4)
    for r in reqs:
        assert src.submit(r)
    _drain(src)
    assert src.handed_off == len(handoffs) > 0
    dst = dst_sched(dst_engine)
    adopted, pending = {}, list(handoffs)
    while pending or not dst.idle:
        if pending:
            req, arrays, pages_used = pending[0]
            item = dst_cls(rid=req.rid, prompt=np.asarray(req.prompt, np.int32),
                           max_new=req.max_new, tokens=list(req.tokens),
                           next_pos=req.next_pos, order=req.order)
            if dst.adopt(item):
                dst_engine.import_slot(item.slot, arrays, pages_used)
                adopted[item.rid] = item
                pending.pop(0)
                continue
        dst.tick()
    return [adopted[r.rid].tokens if r.rid in adopted else r.tokens for r in reqs]


@pytest.mark.parametrize("source", ["jax", "torch"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantized_slot_continues_across_frameworks(jax_container, torch_container, fmt,
                                                    source):
    """A quantized paged slot exported by one framework after its first
    token and imported by the other decodes on to the tokens of one
    engine serving everything (the destination's own framework)."""
    kw = dict(slots=2, max_len=48, chunk=8, paged=True, quantize=fmt)
    cfg = get_config(ARCH).reduced()
    jserver = JaxServer(jax_get_config(ARCH).reduced(), jax_container, **kw)
    params = jax.tree.map(np.asarray, jserver.engine.params)
    seed = _seed("kvhandoff", fmt, source)
    if source == "jax":
        whole = _serve(Server(cfg, torch_container, device="cpu", params=params, **kw),
                       Request, seed, n=4)
        got = _handoff(jserver.engine, JaxScheduler, JaxRequest,
                       TorchEngine(cfg, torch_container, device="cpu", params=params, **kw),
                       Scheduler, Request, seed)
    else:
        whole = _serve(jserver, JaxRequest, seed, n=4)
        dst = JaxServer(jax_get_config(ARCH).reduced(), jax_container, **kw).engine
        got = _handoff(TorchEngine(cfg, torch_container, device="cpu", params=params, **kw),
                       Scheduler, Request, dst, JaxScheduler, JaxRequest, seed)
    assert got == whole


@pytest.mark.parametrize("flags", [["--quantize", "int8"],
                                   ["--quantize", "fp8", "--paged", "--window", "8"]],
                         ids=["int8", "fp8-paged-windowed"])
def test_cli_serves_quantized_on_cpu(capsys, flags):
    assert serve_main(["--device", "cpu", "--requests", "3", "--max-new", "3", *flags]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out and f"quantize={flags[1]}" in out
