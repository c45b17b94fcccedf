"""The port's quantized-weight path held against the JAX package, on the CPU.

  * numerics: `quantize`, `quantize_per_channel` and `dequantize` give the
    JAX package's codes and scales bit for bit, fp32 and bf16 inputs, int8
    and fp8, axis -2 and -1, zero channels (the EPS floor) and values past
    the clip;
  * the op: `quant_matmul_ref` and the CUDA wrapper (on CPU tensors, its
    plain version) against JAX's `quant_matmul_ref` and the Pallas kernel
    in interpret mode over the quantization grid's geometries, within
    5 x 2e-5 (as tests/test_quant_conformance.py), and inside QMM_ENVELOPE
    of the fp32 product; the wrapper's checks on CPU and meta tensors;
  * weights: `quantize_tree` picks the JAX quantizer's leaves and codes on
    the reduced qwen2.5-14b and moonshot trees; the port's checkpoint
    reader restores JAX saves (int8, fp8, plain bf16) to the bits JAX's
    own restore gives, and `verify=True` catches a flipped byte;
  * the model: the reduced qwen2.5-14b with `quantize_tree` weights (fp32)
    against the JAX model, within 1e-4 of the largest logit, for
    `prefill`, chunked `prefill_into` and `decode`, through the references
    and through the kernel path; the embedding bit for bit;
  * serving: the port's `Server` on a quantized tree gives the greedy
    tokens of the JAX engine driving the same tree over its full-precision
    cache, contiguous and paged (`TorchEngine(quantize=)`, which quantizes
    the KV cache too, is held in tests/test_torch_kvquant.py).

Inputs are drawn with numpy from a crc32 seed of the case id.
"""

import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manifest import quantize_tree as jax_quantize_tree
from repro.checkpoint.manifest import restore_checkpoint as jax_restore
from repro.checkpoint.manifest import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.core import Runtime as JaxRuntime
from repro.core.platform import POD_SIM
from repro.kernels import quant as jq
from repro.kernels.ops import _NATIVES_INTERPRET
from repro.kernels.ops import register_all as jax_register_all
from repro.kernels.quant_matmul_ref import quant_matmul_ref as jax_qmm_ref
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import Server as JaxServer
from repro.launch.train import make_bundle as jax_make_bundle
from repro.models.layers import dequant_param as jax_dequant_param
from repro.models.model import Model as JaxModel
from repro_torch.checkpoint.manifest import quantize_tree, restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import _to_torch, params_from_jax
from repro_torch.core.runtime import Runtime
from repro_torch.kernels import _build
from repro_torch.kernels import quant as tq
from repro_torch.kernels.ops import _NATIVES as TORCH_NATIVES
from repro_torch.kernels.ops import PORTED_OPS
from repro_torch.kernels import quant_matmul as qmm_module
from repro_torch.kernels.quant_matmul import plan, quant_matmul, splits
from repro_torch.kernels.quant_matmul_ref import quant_matmul_ref
from repro_torch.launch.bundle import make_bundle
from repro_torch.launch.serve import Request, Server
from repro_torch.models.layers import dequant_param
from repro_torch.models.model import Model

ARCH = "qwen2.5-14b"
MOONSHOT = "moonshot-v1-16b-a3b"
TOL = 2e-5                 # the quantization grid's fp32 tolerance
QMM_ENVELOPE = {"int8": 0.35, "fp8": 1.50}   # as tests/test_quant_conformance.py
# (t, d, f), as tests/test_quant_conformance.py's QMM_GEOMS
QMM_GEOMS = [(8, 32, 32), (60, 64, 64), (7, 48, 32), (16, 32, 64)]
MODEL_TOL = 1e-4           # of the largest logit
SLOTS, MAX_LEN, CHUNK = 3, 32, 5


def _seed(*parts) -> int:
    return zlib.crc32(":".join(map(str, parts)).encode()) & 0x7FFFFFFF


def _bits(a) -> np.ndarray:
    """The raw bits of a JAX array, numpy array or torch tensor, for a
    bit-for-bit comparison (bf16 and fp8 have no numpy dtype of torch's)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.uint16).numpy()
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.uint8)
    return a


def _same(got, want) -> None:
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
    np.testing.assert_array_equal(g, w)


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    return jnp.asarray(a, jnp.dtype(dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _to_torch_tree(tree):
    """A numpy tree (or leaf) as torch tensors with the same bits."""
    if isinstance(tree, dict):
        return {k: _to_torch_tree(v) for k, v in tree.items()}
    return _to_torch(tree)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def test_constants_and_formats_equal_the_jax_package():
    assert (tq.INT8_MAX, tq.FP8_MAX, tq.EPS, tq.FORMATS) == \
        (jq.INT8_MAX, jq.FP8_MAX, jq.EPS, jq.FORMATS)
    assert tq.storage_dtype("int8") == torch.int8
    assert tq.storage_dtype("fp8") == torch.float8_e4m3fn
    with pytest.raises(ValueError):
        tq.storage_dtype("int4")


def _grid_input(dtype, fmt, axis):
    """Normal draws with a zero channel (the EPS floor) and a zero row."""
    a = (np.random.default_rng(_seed("quant", dtype, fmt, axis))
         .standard_normal((48, 40)) * 3).astype(np.float32)
    a[:, 3] = 0.0
    a[5, :] = 0.0
    return a


@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_channel_codes_scales_and_dequant_are_bit_identical(dtype, fmt, axis):
    ja, ta = _both(_grid_input(dtype, fmt, axis), dtype)
    jcodes, jscale = jq.quantize_per_channel(ja, axis=axis, fmt=fmt)
    tcodes, tscale = tq.quantize_per_channel(ta, axis=axis, fmt=fmt)
    _same(tcodes, jcodes)
    _same(tscale, jscale)
    assert tscale.dtype == torch.float32 and bool((tscale > 0).all())
    _same(tq.dequantize(tcodes, tscale, axis=axis, dtype=getattr(torch, dtype)),
          jq.dequantize(jcodes, jscale, axis=axis, dtype=jnp.dtype(dtype)))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_tensor_codes_are_bit_identical_zero_and_past_the_clip(dtype, fmt):
    a = np.random.default_rng(_seed("whole", dtype, fmt)).standard_normal((16, 24))
    a = a.astype(np.float32)
    ja, ta = _both(a, dtype)
    for args in ((), (0.001,)):     # amax scale; a calibrated scale far below amax / top
        jcodes, jscale = jq.quantize(ja, fmt, *args)
        tcodes, tscale = tq.quantize(ta, fmt, *args)
        _same(tcodes, jcodes)
        _same(tscale, jscale)
    # values past +-127 (int8) or +-448 (fp8) times the scale clip
    top = jq.INT8_MAX if fmt == "int8" else jq.FP8_MAX
    assert float(tcodes.float().abs().max()) == top
    zeros = np.zeros((8, 16), np.float32)
    jz, tz = _both(zeros, dtype)
    for jres, tres in ((jq.quantize(jz, fmt), tq.quantize(tz, fmt)),
                       (jq.quantize_per_channel(jz, -2, fmt),
                        tq.quantize_per_channel(tz, -2, fmt))):
        _same(tres[0], jres[0])
        _same(tres[1], jres[1])
        assert bool((tres[1] > 0).all()) and not tres[0].float().any()


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

def _qmm_inputs(geom, fmt):
    t, d, f = geom
    rng = np.random.default_rng(_seed("qmm", geom, fmt))
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((d, f)).astype(np.float32)
    jcodes, jscale = jq.quantize_per_channel(jnp.asarray(w), axis=-2, fmt=fmt)
    return x, w, jcodes, jscale


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("geom", QMM_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_quant_matmul_matches_jax_ref_and_pallas_kernel(geom, fmt):
    x, w, jcodes, jscale = _qmm_inputs(geom, fmt)
    tcodes, tscale = _to_torch(jcodes), torch.from_numpy(np.array(jscale))
    tx = torch.from_numpy(x)
    ref = quant_matmul_ref(tx, tcodes, tscale)
    wrapped = quant_matmul(tx, tcodes, tscale)          # CPU tensors: the plain version
    assert ref.dtype == torch.float32 and ref.shape == (geom[0], geom[2])
    assert torch.equal(wrapped, ref)
    jx = jnp.asarray(x)
    for want in (jax_qmm_ref(jx, jcodes, jscale),
                 _NATIVES_INTERPRET["quant_matmul"](jx, jcodes, jscale)):
        np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=5 * TOL, rtol=5 * TOL)
    err = float(np.abs(ref.numpy() - x @ w).max())
    assert err <= QMM_ENVELOPE[fmt], f"{fmt} error {err} outside the envelope"


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quant_matmul_keeps_bf16_activations(fmt):
    x, _, jcodes, jscale = _qmm_inputs((16, 32, 64), fmt)
    jx, tx = _both(x, "bfloat16")
    got = quant_matmul(tx, _to_torch(jcodes), torch.from_numpy(np.array(jscale)))
    assert got.dtype == torch.bfloat16
    _same(got, jax_qmm_ref(jx, jcodes, jscale))


@pytest.mark.parametrize("bad", ["rank", "chain", "scale-len", "x-dtype", "code-dtype",
                                 "scale-dtype", "layout", "stride"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_quant_matmul_wrapper_checks_on_every_device(bad, device):
    x = torch.zeros(4, 32, device=device)
    q = torch.zeros(32, 64, dtype=torch.int8, device=device)
    s = torch.ones(64, device=device)
    if bad == "rank":
        x = x[None]
    elif bad == "chain":
        q = torch.zeros(16, 64, dtype=torch.int8, device=device)
    elif bad == "scale-len":
        s = torch.ones(32, device=device)
    elif bad == "x-dtype":
        x = x.half()
    elif bad == "code-dtype":
        q = q.to(torch.int16)
    elif bad == "scale-dtype":
        s = s.bfloat16()
    elif bad == "layout":       # 40 one-byte codes a row: not whole 16-byte vectors
        q, s = torch.zeros(32, 40, dtype=torch.int8, device=device), torch.ones(40, device=device)
    else:
        q = torch.zeros(64, 32, dtype=torch.int8, device=device).t()
    with pytest.raises((ValueError, TypeError)):
        quant_matmul(x, q, s)


def test_quant_matmul_off_the_cpu_launches_or_counts_nothing(monkeypatch):
    """Off the CPU the wrapper never takes the plain version: it asks for
    the kernel library (meta tensors stand in for the card's, which take
    the same branch), and an empty output launches and counts nothing."""
    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_build, "library", no_build)
    before = dict(_build.LAUNCHES)
    for t, f in ((0, 64), (4, 0)):
        x = torch.empty(t, 32, device="meta")
        q = torch.empty(32, f, dtype=torch.float8_e4m3fn, device="meta")
        assert quant_matmul(x, q, torch.empty(f, device="meta")).shape == (t, f)
    assert dict(_build.LAUNCHES) == before
    x = torch.empty(4, 32, device="meta")
    with pytest.raises(AssertionError, match="library"):
        quant_matmul(x, torch.empty(32, 64, dtype=torch.int8, device="meta"),
                     torch.empty(64, device="meta"))


@pytest.mark.parametrize("t, d, f, rows, resident, sms, want", [
    # an H100 SXM (132 SMs); the narrow kernel's 4-row tile at two blocks
    # an SM, the row kernel's 32-row tile at three
    (4, 5120, 13824, 4, 2, 132, (2, 2560)),     # decode tick, w_in / w_gate: 108 column tiles
    (4, 13824, 5120, 4, 2, 132, (6, 2304)),     # decode tick, w_out: 40 column tiles
    (4, 5120, 152064, 4, 2, 132, (1, 5120)),    # LM head: 1188 column tiles fill the card
    (128, 5120, 13824, 32, 3, 132, (1, 5120)),  # prefill chunk, w_in: 432 tiles
    (128, 13824, 5120, 32, 3, 132, (2, 6912)),  # prefill chunk, w_out: 160 tiles
    (1316, 5120, 13824, 32, 3, 132, (1, 5120)),  # whole prompt
    (4, 13824, 5120, 4, 2, 114, (5, 2816)),     # an H100 PCIe's 114 SMs: fewer ranges
    (4, 13824, 5120, 4, 3, 132, (9, 1536)),     # more blocks resident: more ranges
    (7, 48, 32, 32, 3, 132, (1, 64)),
    (5, 0, 16, 32, 3, 132, (1, 64)),
    # bf16 x with T > 4 takes the tensor-core kernel: 128-row tiles, one block an SM
    (128, 5120, 13824, 128, 1, 132, (1, 5120)),   # prefill chunk, w_in: 108 tiles
    (128, 13824, 5120, 128, 1, 132, (3, 4608)),   # prefill chunk, w_out: 40 tiles
    (1316, 5120, 13824, 128, 1, 132, (1, 5120)),  # whole prompt, w_in: 1188 tiles
    (1316, 13824, 5120, 128, 1, 132, (1, 13824)),  # whole prompt, w_out: 440 tiles
])
def test_contraction_splits_cover_d_in_whole_steps(t, d, f, rows, resident, sms, want):
    n, kchunk = splits(t, d, f, rows, resident, sms)
    assert (n, kchunk) == want
    assert kchunk % 64 == 0 and (n - 1) * kchunk < max(d, 1) <= n * kchunk
    assert n == 1 or _cdiv(t, rows) * _cdiv(f, 128) * n <= sms * resident   # one wave


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("x_dtype, rows", [(torch.float32, 32), (torch.bfloat16, 128)])
def test_plan_takes_the_row_tile_of_the_kernel_x_dtype_launches(monkeypatch, x_dtype, rows):
    """The split is planned from the occupancy of the kernel the launch
    takes, asked for by x's dtype: fp32 x keeps the 32-row FMA kernel,
    bf16 x (T > 4) the 128-row tensor-core kernel.  The query is stubbed
    with an H100's answers (meta tensors stand in for the card's)."""
    answers = {0: (32, 3, 132), 1: (128, 1, 132)}   # by dtype code, T > 4
    asked = []

    def query(device, dtype, code, t):
        asked.append((device, dtype, code, t))
        return answers[dtype]

    monkeypatch.setattr(qmm_module, "occupancy", query)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    x = torch.empty(128, 13824, dtype=x_dtype, device="meta")
    qw = torch.empty(13824, 5120, dtype=torch.int8, device="meta")
    assert plan(x, qw) == splits(128, 13824, 5120, rows, *answers[_build.dtype_code(x, "")][1:])
    assert asked == [(0, _build.dtype_code(x, ""), 0, 128)]
    assert answers[asked[0][1]][0] == rows


def _bf16_bits_to_float(bits):
    """float32 values of bf16 bit patterns (uint16 -> the high half of a float32)."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def _kernel_decode(fmt, codes):
    """The tensor-core kernel's decode (common.cuh, int8x2_to_bf16x2 and
    e4m3x2_to_bf16x2), emulated bit for bit: two codes at bits 0-7 and
    16-23 of a word, masked and or-ed into a bf16 pair, then one exact
    bf16x2 FMA.  Returns float64."""
    b = np.asarray(codes, np.uint32)
    t = b | (b << 16)                                  # the code in both halves
    lo16 = lambda w: (w & 0xFFFF).astype(np.uint16)
    if fmt == "int8":
        lo = (t & 0x007F007F) | 0x43004300             # 128 + l
        nhi = (t & 0x00800080) | 0xC300C300            # -(128 + 128 s)
        return (_bf16_bits_to_float(lo16(lo)).astype(np.float64)
                + _bf16_bits_to_float(lo16(nhi)).astype(np.float64))
    v = ((t << 8) & 0x80008000) | ((t << 4) & 0x07F007F0)
    return _bf16_bits_to_float(lo16(v)).astype(np.float64) * 2.0 ** 120


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_every_code_is_exact_in_bf16_and_in_the_kernel_decode(fmt):
    """What the tensor-core kernel rests on: every int8 code (-128 .. 127)
    and every finite e4m3 bit pattern survives code -> bf16 -> float32
    unchanged, and the kernel's bit-level decode gives that value (a bf16,
    so its product with a bf16 activation is exact in fp32)."""
    bits = np.arange(256, dtype=np.uint8)
    if fmt == "fp8":
        bits = bits[(bits & 0x7F) != 0x7F]            # the two NaN patterns
    codes = torch.from_numpy(bits).view(tq.STORAGE_DTYPES[fmt])
    want = codes.float()
    assert torch.isfinite(want).all() and len(torch.unique(want)) == len(bits) - (fmt == "fp8")
    assert torch.equal(codes.to(torch.bfloat16).float(), want)
    got = _kernel_decode(fmt, bits)
    assert np.array_equal(got, want.double().numpy())
    assert np.array_equal(np.signbit(got), np.signbit(want.numpy()))   # -0.0 stays -0.0
    assert torch.equal(torch.from_numpy(got).float().bfloat16().float(), want)   # a bf16 value


# ---------------------------------------------------------------------------
# weights: the quantizer and the checkpoint reader
# ---------------------------------------------------------------------------

def _jax_tree(arch, dtype="float32"):
    tree = JaxModel(jax_get_config(arch).reduced()).init(jax.random.PRNGKey(0))
    if dtype != "float32":
        tree = jax.tree.map(lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating)
                            and a.ndim >= 2 else a, tree)
    return tree


def _flat(tree, prefix=""):
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], path)
        else:
            yield path, tree[k]


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("arch, dtype", [(ARCH, "float32"), (ARCH, "bfloat16"),
                                         (MOONSHOT, "float32")])
def test_quantize_tree_picks_the_jax_leaves_and_codes(arch, dtype, fmt):
    jtree = _jax_tree(arch, dtype)
    theirs = dict(_flat(jax_quantize_tree(jtree, fmt)))
    ours = dict(_flat(quantize_tree(_to_torch_tree(jax.tree.map(np.asarray, jtree)), fmt)))
    assert set(ours) == set(theirs)
    quantized = {p.rsplit("/", 1)[0] for p in ours if p.endswith("/q")}
    assert "lm_head/w" in quantized and "embed/tok" in quantized
    assert not any("/moe/" in p for p in quantized)          # moonshot's experts stay
    for path in ours:
        _same(ours[path], theirs[path])


def _save_all(tmp_path, jtree):
    """The JAX package's int8, fp8 and plain saves of `jtree`."""
    dirs = {}
    for kind in ("int8", "fp8", None):
        d = tmp_path / str(kind)
        jax_save(d, 3, jtree, quantize=kind)
        dirs[kind] = d
    return dirs


@pytest.mark.parametrize("dequantize", [False, True])
def test_checkpoint_reader_restores_jax_saves_bit_for_bit(tmp_path, dequantize):
    jtree = _jax_tree(ARCH, "bfloat16")
    for kind, d in _save_all(tmp_path, jtree).items():
        theirs, step = jax_restore(d, jtree, dequantize=dequantize)
        ours, ostep = restore_checkpoint(d, jtree, dequantize=dequantize, verify=True)
        assert ostep == step == 3
        theirs, ours = dict(_flat(theirs)), dict(_flat(ours))
        assert set(ours) == set(theirs), kind
        for path in ours:
            assert ours[path].device.type == "cpu"
            _same(ours[path], theirs[path])
        if kind is not None and not dequantize:
            assert ours["lm_head/w/q"].dtype == tq.storage_dtype(kind)


def test_checkpoint_reader_verify_catches_a_flipped_byte(tmp_path):
    jtree = _jax_tree(ARCH)
    d = tmp_path / "ckpt"
    path = jax_save(d, 1, jtree, quantize="int8")
    restore_checkpoint(d, jtree, verify=True)
    blob = path / "data.blob"
    raw = bytearray(blob.read_bytes())
    raw[len(raw) // 2] ^= 0x40
    blob.write_bytes(bytes(raw))
    restore_checkpoint(d, jtree)                    # unverified: reads the damage
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(d, jtree, verify=True)


def test_checkpoint_reader_loads_no_model_layer():
    """The reader and the quantizer need numpy, json and the quantization
    numerics only: importing them loads neither the model nor the weights
    bridge."""
    code = ("import json, sys, repro_torch.checkpoint.manifest; "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(Path(__file__).parents[1] / "src")})
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m.startswith(("repro_torch.models", "repro_torch.convert"))
                or m == "repro" or m.startswith("repro.")], loaded


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    return JaxModel(jax_get_config(ARCH).reduced()).init(jax.random.PRNGKey(0))


def _jax_binding(kernels: bool):
    if not kernels:
        return None   # the JAX model's default: references
    from repro.core.registry import OpRegistry as JaxRegistry

    reg = jax_register_all(JaxRegistry())
    return reg.bind(reg.declared(), POD_SIM, native=True, freeze=False)


def _torch_binding(kernels: bool):
    if not kernels:
        rt = Runtime(host_env={})
        binding = rt.deploy(make_bundle(ARCH, reduced=True), device="cpu").binding
        rt.cleanup()
        return binding
    return {op: TORCH_NATIVES[op] for op in PORTED_OPS}


def _quant_pair(jax_params, fmt, kernels):
    cfg = get_config(ARCH).reduced()
    qtree = jax_quantize_tree(jax_params, fmt)
    jm = JaxModel(jax_get_config(ARCH).reduced(), binding=_jax_binding(kernels))
    tm = Model(cfg, _torch_binding(kernels), device="cpu").load_params(
        params_from_jax(jax.tree.map(np.asarray, qtree), cfg))
    return qtree, jm, tm


def _close(got, want):
    want = np.asarray(want)
    tol = MODEL_TOL * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def test_storage_form_binds_codes_and_scales():
    cfg = get_config(ARCH).reduced()
    tree = JaxModel(jax_get_config(ARCH).reduced()).init(jax.random.PRNGKey(1))
    tm = Model(cfg, {}, device="cpu").load_params(
        params_from_jax(jax.tree.map(np.asarray, jax_quantize_tree(tree, "fp8")), cfg))
    mlp = tm.layers[0].mlp
    assert mlp["w_in"]["q"].dtype == torch.float8_e4m3fn
    assert mlp["w_in"]["scale"].shape == (cfg.d_ff,) and mlp["w_in"]["scale"].dtype == torch.float32
    assert tm.lm_head["w"]["q"].shape == (cfg.d_model, tm.padded_vocab)
    assert tm.layers[0].pre_norm["scale"].dtype == torch.float32     # norms stay
    # the structure follows the state: a full-precision state binds plain leaves again
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, tree), cfg))
    assert isinstance(tm.layers[0].mlp["w_in"], torch.Tensor)


def test_params_from_jax_checks_storage_form_shapes(jax_params):
    cfg = get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, jax_quantize_tree(jax_params, "int8"))
    tree["lm_head"]["w"]["scale"] = tree["lm_head"]["w"]["scale"][:8]
    with pytest.raises(ValueError, match="lm_head/w/scale"):
        params_from_jax(tree, cfg)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_embedding_and_dequantized_leaves_are_bit_identical(jax_params, fmt):
    qtree, jm, tm = _quant_pair(jax_params, fmt, False)
    tokens = np.random.default_rng(_seed("embed", fmt)).integers(0, 256, (2, 7))
    _same(tm._embed(torch.from_numpy(tokens)), jm._embed(qtree, jnp.asarray(tokens)))
    wq = qtree["decoder"]["p0"]["attn"]["wq"]
    tw = {"q": tm.layers[1].attn["wq"]["q"], "scale": tm.layers[1].attn["wq"]["scale"]}
    _same(dequant_param(tw, torch.float32),
          jax_dequant_param({"q": wq["q"][1], "scale": wq["scale"][1]}, jnp.float32))


@pytest.mark.parametrize("kernels", [False, True], ids=["refs", "kernels"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_prefill_matches_jax(jax_params, fmt, kernels):
    qtree, jm, tm = _quant_pair(jax_params, fmt, kernels)
    tokens = np.random.default_rng(_seed("qprefill", fmt, kernels)).integers(0, 256, (2, 11))
    jl, _ = jax.jit(jm.prefill)(qtree, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, _ = tm.prefill({"tokens": torch.from_numpy(tokens)})
    _close(tl, jl)


@pytest.mark.parametrize("kernels", [False, True], ids=["refs", "kernels"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_chunked_prefill_and_decode_match_jax(jax_params, fmt, kernels):
    """prefill_into 5 + 5 + 3 tokens into slot 1, then two decode ticks
    with slot 2 parked: logits within 1e-4 of the largest."""
    qtree, jm, tm = _quant_pair(jax_params, fmt, kernels)
    rng = np.random.default_rng(_seed("qsteps", fmt, kernels))
    jcache, tcache = jm.init_cache(SLOTS, MAX_LEN), tm.init_cache(SLOTS, MAX_LEN)
    prompt = rng.integers(0, 256, 13)
    step, slot = jax.jit(jm.prefill_into), 1
    for start in range(0, len(prompt), CHUNK):
        n = min(CHUNK, len(prompt) - start)
        buf = np.zeros((1, CHUNK), np.int32)
        buf[0, :n] = prompt[start:start + n]
        jl, jcache = step(qtree, jnp.asarray(buf), jcache, jnp.int32(slot), jnp.int32(start),
                          jnp.int32(n))
        tl, tcache = tm.prefill_into(torch.from_numpy(buf), tcache, slot, start, n)
        _close(tl, jl)
    pos = np.array([4, len(prompt), MAX_LEN - 1], np.int32)
    active = np.array([True, True, False])
    decode = jax.jit(jm.decode)
    for _ in range(2):
        token = rng.integers(0, 256, (SLOTS, 1)).astype(np.int32)
        jl, jcache = decode(qtree, jnp.asarray(token), jcache, jnp.asarray(pos),
                            jnp.asarray(active))
        tl, tcache = tm.decode(torch.from_numpy(token), tcache, torch.from_numpy(pos), active)
        _close(tl[:2], jl[:2])
        pos = pos + active


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


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_server_on_a_quantized_tree_gives_the_jax_tokens(jax_container, torch_container,
                                                        fmt, paged):
    """The JAX engine drives the same storage-form tree through its model's
    prefill_into / decode over a full-precision cache (its quantize= would
    quantize the cache too)."""
    kw = dict(slots=2, max_len=48, chunk=8, paged=paged)
    cfg = get_config(ARCH).reduced()
    jserver = JaxServer(jax_get_config(ARCH).reduced(), jax_container, **kw)
    jserver.engine.params = jax.tree.map(jnp.asarray,
                                         jax_quantize_tree(jserver.engine.params, fmt))
    tserver = Server(cfg, torch_container, device="cpu",
                     params=jax.tree.map(np.asarray, jserver.engine.params), **kw)
    assert tserver.engine.model.layers[0].mlp["w_out"]["q"].dtype == tq.storage_dtype(fmt)
    seed = _seed("qserve", fmt, paged)
    for server, cls in ((jserver, JaxRequest), (tserver, Request)):
        for r in _requests(cls, seed):
            assert server.submit(r)
        server.run()
    assert all(r.done for r in tserver.requests)
    assert [r.tokens for r in tserver.requests] == [r.tokens for r in jserver.requests]
    assert tserver.engine.decode_calls == jserver.engine.decode_calls
