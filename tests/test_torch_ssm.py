"""The port's Mamba-2 slice held against the JAX package, on the CPU.

  * the config copy (mamba2-780m) equals its original;
  * the scan: `ssd_scan_ref` against the JAX reference and the JAX Pallas
    kernel in interpret mode (as tests/test_kernels.py runs it), one and
    two groups, the whole sequence as one chunk, a divisor and the
    gcd-reduced chunk the layer picks, dt zero on the last rows: fp32
    within 2e-5 and bf16 within 2e-2 of max |ref|; `ssd_decode_step_ref`
    against JAX; the CUDA wrapper's checks on CPU and meta tensors, its
    CPU path (the plain version) and its meta path (the kernel library);
  * the layer: `ssm_apply`, `ssm_prefill_chunk` (at pos 0 over a garbage
    state, with a carried state, with n_valid < C) and `ssm_decode`
    against JAX in fp32 within 1e-5;
  * the model: reduced mamba2 `prefill`, `prefill_into` (contiguous and
    paged) and `decode` with a parked row against the JAX fp32 logits
    within 1e-4 of the largest, the parked row's state bit-identical; a
    tied reduced qwen2.5-14b (the tied head on a dense model);
    `params_from_jax` on the tied SSM tree; the full-width schema;
  * serving: `TorchEngine` greedy tokens equal to `JaxEngine`'s, chunked
    contiguous and paged and decode-mode prefill; a JAX slot export
    imported into a TorchEngine continues token-identically; the CLI
    serves mamba2 on the CPU; a deployment lists `ssd_scan` as ported,
    its native provider `cuda`.

Inputs are drawn with numpy from a crc32 seed of the case and handed to
both frameworks; bf16 inputs are the same fp32 draws rounded once.
"""

import dataclasses
import math
import re
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import Runtime as JaxRuntime
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan_ref import ssd_decode_step_ref as jax_decode_step
from repro.kernels.ssd_scan_ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import Scheduler as JaxScheduler
from repro.launch.serve import Server as JaxServer
from repro.launch.train import make_bundle as jax_make_bundle
from repro.models import ssm as jax_ssm
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.platform import CUDA_KERNELS
from repro_torch.core.runtime import Runtime
from repro_torch.kernels import _build
from repro_torch.kernels.ops import PORTED_OPS, register_all
from repro_torch.kernels.ssd_scan import MAX_CHUNK, MAX_STATE, ssd_scan
from repro_torch.kernels.ssd_scan_ref import ssd_decode_step_ref, ssd_scan_ref
from repro_torch.launch.bundle import make_bundle
from repro_torch.launch.serve import Request, Scheduler, Server, TorchEngine
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import ssm
from repro_torch.models.model import Model

MAMBA, QWEN = "mamba2-780m", "qwen2.5-14b"
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}   # of max |ref|, as the kernel grids
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4


def _seed(*parts) -> int:
    return zlib.crc32(":".join(map(str, parts)).encode()) & 0x7FFFFFFF


def _both(a: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    return jnp.asarray(a, jnp.dtype(dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close_rel(got, want, tol):
    """max |got - want| <= tol * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"max abs err {err:.3g} > {tol} x max |want| {scale:.3g}"


# ---------------------------------------------------------------------------
# config copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_mamba2_config_copy_equals_original(reduced):
    ours, theirs = get_config(MAMBA), jax_get_config(MAMBA)
    if reduced:
        ours, theirs = ours.reduced(), theirs.reduced()
    assert ours.to_dict() == theirs.to_dict()
    assert ours.param_count() == theirs.param_count()
    assert make_bundle(MAMBA, reduced=reduced).digest == \
        jax_make_bundle(MAMBA, reduced=reduced).digest


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

def _ssd_draws(seed, b, s, h, p, g, n, live=None):
    """tests/test_kernels.py's spread: x N(0, 0.5^2), B and C N(0, 0.3^2),
    dt = softplus(N(0, 1)), A = -exp(N(0, 0.3^2)); dt zero past `live`."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, s, h, p))).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    if live is not None:
        dt[:, live:] = 0
    a = (-np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    bm = (0.3 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    cm = (0.3 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    return x, dt, a, bm, cm


def _ssd_pair(draws, dtype):
    """(JAX args, torch args): x, B and C in `dtype`, dt and A float32."""
    x, dt, a, bm, cm = draws
    j, t = zip(*(_both(v, dtype if i in (0, 3, 4) else "float32")
                 for i, v in enumerate((x, dt, a, bm, cm))))
    return j, t


S = 24
# the whole sequence; a divisor; the layer's pick for a config chunk of 16
SSD_CHUNKS = {"whole": S, "divisor": 6, "gcd": math.gcd(16, S)}


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("chunk", list(SSD_CHUNKS))
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_ref_matches_jax(g, chunk, dtype):
    q = SSD_CHUNKS[chunk]
    jargs, targs = _ssd_pair(_ssd_draws(_seed("ssd", g, chunk, dtype), 2, S, 4, 8, g, 16,
                                        live=19), dtype)
    y, st = ssd_scan_ref(*targs, chunk=q)
    assert y.dtype == targs[0].dtype and st.dtype == torch.float32
    assert y.shape == (2, S, 4, 8) and st.shape == (2, 4, 16, 8)
    jy, jst = jax_ssd_scan_ref(*jargs, chunk=q)
    _close_rel(y, jy, TOLS[dtype])
    _close_rel(st, jst, TOLS[dtype])
    # the Pallas kernel, as the JAX package's tests run it on the CPU
    ky, kst = jax_ssd_scan(*jargs, chunk=q, interpret=True)
    _close_rel(y, ky, TOLS[dtype])
    _close_rel(st, kst, TOLS[dtype])


def test_ssd_scan_ref_keeps_the_state_on_dt_zero_rows():
    """dt = 0 on the last rows: decay 1 and no input, so the final state
    is the state after the last live row (the padded prefill chunk)."""
    x, dt, a, bm, cm = _ssd_draws(_seed("ssd-pad"), 1, 16, 2, 4, 1, 8, live=11)
    t = [torch.from_numpy(v) for v in (x, dt, a, bm, cm)]
    _, st_full = ssd_scan_ref(*t, chunk=16)
    _, st_live = ssd_scan_ref(*(v[:, :11] if v.dim() > 1 else v for v in t), chunk=11)
    _close_rel(st_full, st_live, 1e-6)


def test_ssd_decode_step_ref_matches_jax():
    rng = np.random.default_rng(_seed("ssd-decode"))
    b, h, p, g, n = 3, 4, 8, 2, 16
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, h)), 0).astype(np.float32)
    a = (-np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, g, n)).astype(np.float32) for _ in range(2))
    state = rng.standard_normal((b, h, n, p)).astype(np.float32)
    args = (x, dt, a, bm, cm, state)
    y, st = ssd_decode_step_ref(*(torch.from_numpy(v) for v in args))
    jy, jst = jax_decode_step(*(jnp.asarray(v) for v in args))
    _close_rel(y, jy, LAYER_TOL)
    _close_rel(st, jst, LAYER_TOL)


def _wrapper_args(device, bad=None):
    b, s, h, p, g, n, chunk = 1, 8, 4, 8, 2, 16, 4
    x = torch.zeros(b, s, h, p, device=device)
    dt = torch.zeros(b, s, h, device=device)
    a = torch.zeros(h, device=device)
    bm, cm = torch.zeros(b, s, g, n, device=device), torch.zeros(b, s, g, n, device=device)
    if bad == "rank":
        x = x[0]
    elif bad == "dt-shape":
        dt = torch.zeros(b, s, h + 1, device=device)
    elif bad == "groups":          # 4 heads do not split into 3 groups
        bm, cm = torch.zeros(b, s, 3, n, device=device), torch.zeros(b, s, 3, n, device=device)
    elif bad == "state-size":
        bm = cm = torch.zeros(b, s, g, 129, device=device)
    elif bad == "chunk-divides":
        chunk = 3
    elif bad == "chunk-max":
        x, dt = torch.zeros(b, 256, h, p, device=device), torch.zeros(b, 256, h, device=device)
        bm, cm = (torch.zeros(b, 256, g, n, device=device) for _ in range(2))
        chunk = 256
    elif bad == "x-dtype":
        x = x.half()
    elif bad == "bc-dtype":
        bm = bm.bfloat16()
    elif bad == "dt-dtype":
        dt = dt.bfloat16()
    elif bad == "a-dtype":
        a = a.double()
    elif bad == "layout":
        x = torch.zeros(b, s, p, h, device=device).transpose(2, 3)
    return (x, dt, a, bm, cm), chunk


@pytest.mark.parametrize("bad", ["rank", "dt-shape", "groups", "state-size", "chunk-divides",
                                 "chunk-max", "x-dtype", "bc-dtype", "dt-dtype", "a-dtype",
                                 "layout"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_ssd_scan_wrapper_checks_on_every_device(bad, device):
    args, chunk = _wrapper_args(device, bad)
    with pytest.raises((ValueError, TypeError)):
        ssd_scan(*args, chunk=chunk)


def test_ssd_scan_wrapper_takes_the_plain_version_only_on_the_cpu(monkeypatch):
    """A CPU tensor gets `ssd_scan_ref`'s bits and counts no launch; off the
    CPU the wrapper asks for the kernel library (meta tensors stand in for
    the card's, which take the same branch) and never the plain version."""
    _, targs = _ssd_pair(_ssd_draws(_seed("ssd-cpu"), 1, 16, 4, 8, 2, 16), "float32")
    before = dict(_build.LAUNCHES)
    y, st = ssd_scan(*targs, chunk=8)
    y_ref, st_ref = ssd_scan_ref(*targs, chunk=8)
    assert torch.equal(y, y_ref) and torch.equal(st, st_ref)
    assert dict(_build.LAUNCHES) == before

    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_build, "library", no_build)
    args, chunk = _wrapper_args("meta")
    with pytest.raises(AssertionError, match="library"):
        ssd_scan(*args, chunk=chunk)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("shape", [(1, 0, 4, 8), (0, 16, 4, 8), (1, 16, 4, 0)],
                         ids=["no-steps", "no-rows", "no-columns"])
def test_ssd_scan_counts_no_launch_when_there_is_nothing_to_compute(shape, monkeypatch):
    """Off the CPU an empty x launches nothing, so the wrapper neither
    builds the library nor counts a launch, and its state is the plain
    version's zeros, as JAX's.  (Meta tensors stand in for the card's: they
    take the same branch and hold no data, so the zeros are read on the
    CPU.)"""
    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_build, "library", no_build)
    b, s, h, p = shape
    g, n = 2, 16
    args = [torch.zeros(b, s, h, p), torch.zeros(b, s, h), torch.zeros(h),
            torch.zeros(b, s, g, n), torch.zeros(b, s, g, n)]
    before = dict(_build.LAUNCHES)
    y, st = ssd_scan(*(t.to("meta") for t in args), chunk=8)
    assert dict(_build.LAUNCHES) == before
    y_ref, st_ref = ssd_scan_ref(*args, chunk=8)
    assert y.shape == y_ref.shape and y.dtype == y_ref.dtype
    assert st.shape == st_ref.shape == (b, h, n, p) and st.dtype == torch.float32
    y_jax, st_jax = jax_ssd_scan_ref(*(jnp.asarray(t.numpy()) for t in args), chunk=8)
    assert y_ref.shape == y_jax.shape
    np.testing.assert_array_equal(st_ref.numpy(), np.asarray(st_jax))
    assert bool((st_ref == 0).all())


def test_ssd_scan_wrapper_limits_match_the_kernel_source():
    """The wrapper checks the kernel's chunk and state limits on every
    device, the card's kernel library unbuilt: its constants must be the
    ones the CUDA source refuses beyond."""
    src = (Path(_build.CSRC) / "ssd_scan.cu").read_text()
    limits = dict(re.findall(r"constexpr int (kMaxChunk|kMaxState) = (\d+);", src))
    assert limits == {"kMaxChunk": str(MAX_CHUNK), "kMaxState": str(MAX_STATE)}


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _layer_params(cfg, seed):
    """Numpy draws of one SSM layer's leaves, with the scaled spread."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in ssm.ssm_schema(cfg).items():
        v = rng.standard_normal(spec.shape)
        if spec.init == "scaled":
            v /= np.sqrt(spec.shape[0])
        elif spec.init == "normal":
            v *= spec.scale
        elif spec.init == "ones":
            v = 1 + 0.1 * v
        else:
            v = 0.1 * v
        out[name] = v.astype(np.float32)
    return out


REF_BINDINGS = ({"ssd_scan": jax_ssd_scan_ref}, {"ssd_scan": ssd_scan})


def _layer_case(name):
    cfg, jcfg = get_config(MAMBA).reduced(), jax_get_config(MAMBA).reduced()
    params = _layer_params(cfg, _seed("layer", name))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    return cfg, jcfg, jp, tp, np.random.default_rng(_seed("layer-x", name))


@pytest.mark.parametrize("s", [16, 20, 7], ids=["one-chunk", "gcd-chunk", "short"])
def test_ssm_apply_matches_jax(s):
    cfg, jcfg, jp, tp, rng = _layer_case(f"apply{s}")
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jbind, tbind = REF_BINDINGS
    jy, jstate = jax_ssm.ssm_apply(jp, jnp.asarray(x), jcfg, jbind, return_state=True)
    ty, tstate = ssm.ssm_apply(tp, torch.from_numpy(x), cfg, tbind, return_state=True)
    _close_rel(ty, jy, LAYER_TOL)
    for name in ("state", "conv"):
        _close_rel(tstate[name], jstate[name], LAYER_TOL)


@pytest.mark.parametrize("case", ["pos0-garbage", "carried", "partial"])
def test_ssm_prefill_chunk_matches_jax(case):
    cfg, jcfg, jp, tp, rng = _layer_case(f"chunk-{case}")
    c = 8
    h, p, n, k = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv
    x = rng.standard_normal((1, c, cfg.d_model)).astype(np.float32)
    cache = {"state": rng.standard_normal((1, h, n, p)).astype(np.float32),
             "conv": rng.standard_normal((1, k - 1, cfg.ssm_d_inner)).astype(np.float32)}
    pos, n_valid = {"pos0-garbage": (0, c), "carried": (16, c), "partial": (24, 5)}[case]
    jbind, tbind = REF_BINDINGS
    jy, jc = jax_ssm.ssm_prefill_chunk(jp, jnp.asarray(x), {k_: jnp.asarray(v) for k_, v in
                                                            cache.items()},
                                       jnp.int32(pos), jnp.int32(n_valid), jcfg, jbind)
    ty, tc = ssm.ssm_prefill_chunk(tp, torch.from_numpy(x),
                                   {k_: torch.from_numpy(v) for k_, v in cache.items()},
                                   pos, n_valid, cfg, tbind)
    _close_rel(ty[:, :n_valid], jy[:, :n_valid], LAYER_TOL)
    for name in ("state", "conv"):
        _close_rel(tc[name], jc[name], LAYER_TOL)
    if case == "pos0-garbage":
        # a fresh slot's leftovers are not read: the same as a zero cache
        zero = {k_: torch.zeros(v.shape) for k_, v in cache.items()}
        y0, c0 = ssm.ssm_prefill_chunk(tp, torch.from_numpy(x), zero, 0, c, cfg, tbind)
        assert torch.equal(y0, ty) and all(torch.equal(c0[k_], tc[k_]) for k_ in c0)


def test_ssm_decode_matches_jax():
    cfg, jcfg, jp, tp, rng = _layer_case("decode")
    h, p, n, k = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    cache = {"state": rng.standard_normal((3, h, n, p)).astype(np.float32),
             "conv": rng.standard_normal((3, k - 1, cfg.ssm_d_inner)).astype(np.float32)}
    jy, jc = jax_ssm.ssm_decode(jp, jnp.asarray(x), {k_: jnp.asarray(v)
                                                     for k_, v in cache.items()}, jcfg)
    ty, tc = ssm.ssm_decode(tp, torch.from_numpy(x),
                            {k_: torch.from_numpy(v) for k_, v in cache.items()}, cfg)
    _close_rel(ty, jy, LAYER_TOL)
    for name in ("state", "conv"):
        _close_rel(tc[name], jc[name], LAYER_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    cache = {}

    def get(arch, tied=False):
        if (arch, tied) not in cache:
            cfg = dataclasses.replace(jax_get_config(arch).reduced(), tie_embeddings=True) \
                if tied else jax_get_config(arch).reduced()
            cache[arch, tied] = (JaxModel(cfg), JaxModel(cfg).init(jax.random.PRNGKey(0)))
        return cache[arch, tied]
    return get


def _torch_model(arch, jparams, tied=False):
    cfg = get_config(arch).reduced()
    if tied:
        cfg = dataclasses.replace(cfg, tie_embeddings=True)
    rt = Runtime(host_env={})
    binding = rt.deploy(make_bundle(arch, reduced=True), device="cpu").binding
    rt.cleanup()
    return Model(cfg, binding, device="cpu").load_params(
        params_from_jax(jax.tree.map(np.asarray, jparams), cfg))


def test_mamba2_prefill_matches_jax(jax_params):
    jm, jp = jax_params(MAMBA)
    tm = _torch_model(MAMBA, jp)
    tokens = np.random.default_rng(_seed("m-prefill")).integers(0, 256, (2, 20))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, tc = tm.prefill({"tokens": torch.from_numpy(tokens)})
    _close_rel(tl, jl, MODEL_TOL)
    assert set(tc["p0"]) == {"state", "conv"}
    for name in ("state", "conv"):
        _close_rel(tc["p0"][name], jc["p0"][name], MODEL_TOL)


SLOTS, MAX_LEN, CHUNK = 3, 32, 8


@pytest.mark.parametrize("mode", ["contiguous", "paged"])
def test_mamba2_steps_match_jax(jax_params, mode):
    """prefill_into (8 + 8 + 3: a partial last chunk) into slot 1 of a cache
    holding garbage, then two decode ticks with slot 2 parked: logits and
    caches within 1e-4 of JAX's, and the parked row's state and conv tail
    bit-identical to what they were."""
    jm, jp = jax_params(MAMBA)
    tm = _torch_model(MAMBA, jp)
    rng = np.random.default_rng(_seed("m-steps", mode))
    if mode == "paged":
        nblocks = MAX_LEN // CHUNK
        tables = np.zeros((SLOTS, nblocks), np.int32)
        tables[:2] = rng.permutation(np.arange(1, 1 + 2 * nblocks)).reshape(2, nblocks)
        jcache = jm.init_paged_cache(1 + SLOTS * nblocks, CHUNK, SLOTS)
        tcache = tm.init_paged_cache(1 + SLOTS * nblocks, CHUNK, SLOTS)
    else:
        tables = None
        jcache, tcache = jm.init_cache(SLOTS, MAX_LEN), tm.init_cache(SLOTS, MAX_LEN)
    for name in ("state", "conv"):
        junk = rng.standard_normal(tuple(tcache["p0"][name].shape)).astype(np.float32)
        tcache["p0"][name].copy_(torch.from_numpy(junk))
        jcache["p0"][name] = jnp.asarray(junk)

    prompt = rng.integers(0, 256, 19)
    step, slot = jax.jit(jm.prefill_into), 1
    for start in range(0, len(prompt), CHUNK):
        n = min(CHUNK, len(prompt) - start)
        buf = np.zeros((1, CHUNK), np.int32)
        buf[0, :n] = prompt[start:start + n]
        kw = {} if tables is None else {"block_row": jnp.asarray(tables[slot])}
        jl, jcache = step(jp, jnp.asarray(buf), jcache, jnp.int32(slot), jnp.int32(start),
                          jnp.int32(n), **kw)
        tl, tcache = tm.prefill_into(torch.from_numpy(buf), tcache, slot, start, n,
                                     block_row=None if tables is None else tables[slot])
        _close_rel(tl, jl, MODEL_TOL)

    pos = np.array([9, len(prompt), MAX_LEN - 1], np.int32)
    active = np.array([True, True, False])
    parked = {name: buf[:, 2].clone() for name, buf in tcache["p0"].items()}
    decode = jax.jit(jm.decode)
    for _ in range(2):
        token = rng.integers(0, 256, (SLOTS, 1)).astype(np.int32)
        kw = {} if tables is None else {"block_tables": jnp.asarray(tables)}
        jl, jcache = decode(jp, jnp.asarray(token), jcache, jnp.asarray(pos),
                            jnp.asarray(active), **kw)
        tl, tcache = tm.decode(torch.from_numpy(token), tcache, pos, active, block_tables=tables)
        _close_rel(tl[:2], jl[:2], MODEL_TOL)
        pos = pos + active
    for name in ("state", "conv"):
        _close_rel(tcache["p0"][name], jcache["p0"][name], MODEL_TOL)
        assert torch.equal(tcache["p0"][name][:, 2], parked[name])


def test_tied_dense_model_matches_jax(jax_params):
    """The tied head on a dense decoder: reduced qwen2.5-14b with
    tie_embeddings, no lm_head, prefill and a decode tick within 1e-4."""
    jm, jp = jax_params(QWEN, tied=True)
    assert "lm_head" not in jp
    tm = _torch_model(QWEN, jp, tied=True)
    assert not hasattr(tm, "lm_head")
    tokens = np.random.default_rng(_seed("tied")).integers(0, 256, (2, 9))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, tc = tm.prefill({"tokens": torch.from_numpy(tokens)})
    _close_rel(tl, jl, MODEL_TOL)
    pad = ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))
    jcache = {"p0": {k: jnp.pad(v, pad) for k, v in jc["p0"].items()}}
    tcache = {"p0": {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1))
                     for k, v in tc["p0"].items()}}
    token = np.array([[3], [7]], np.int32)
    jl, _ = jax.jit(jm.decode)(jp, jnp.asarray(token), jcache, jnp.int32(9))
    tl, _ = tm.decode(torch.from_numpy(token), tcache, 9)
    _close_rel(tl, jl, MODEL_TOL)


def test_params_from_jax_on_the_tied_ssm_tree(jax_params):
    cfg = get_config(MAMBA).reduced()
    tree = jax.tree.map(np.asarray, jax_params(MAMBA)[1])
    assert "lm_head" not in tree
    state = params_from_jax(tree, cfg)
    leaves = tree["decoder"]["p0"]["ssm"]
    assert set(leaves) == set(ssm.ssm_schema(cfg))
    for i in range(cfg.num_layers):
        for name, leaf in leaves.items():
            np.testing.assert_array_equal(state[f"layers.{i}.ssm.{name}"].numpy(), leaf[i])
        assert f"layers.{i}.post_norm.scale" not in state
    np.testing.assert_array_equal(state["embed.tok"].numpy(), tree["embed"]["tok"])
    assert not any(k.startswith("lm_head") for k in state)
    # a head the tied schema does not have is refused
    tree["lm_head"] = {"w": np.zeros((cfg.d_model, 256), np.float32)}
    with pytest.raises(KeyError):
        params_from_jax(tree, cfg)


def test_full_width_mamba2_schema():
    cfg = get_config(MAMBA)
    model = Model(cfg, {}, device="meta")
    n = sum(p.numel() for p in model.parameters())
    # param_count() counts the projections and the (unpadded) tied
    # embedding; the model adds the vocab padding (50280 -> 50304) and each
    # layer's small leaves: dt_bias, a_log, d_skip (48 heads), conv_w and
    # conv_b, norm_scale (d_inner), and the pre-norm and final norm
    din, h = cfg.ssm_d_inner, cfg.ssm_heads
    small = 3 * h + cfg.ssm_conv * din + 2 * din + cfg.d_model
    assert n == cfg.param_count()[0] + 24 * cfg.d_model + 48 * small + cfg.d_model
    assert len(model.layers) == 48 and not hasattr(model, "lm_head")
    assert model.layers[0].ssm.w_x.shape == (1536, 3072)
    assert model.embed.tok.shape == (50304, 1536)
    assert not hasattr(model.layers[0], "post_norm") and not hasattr(model.layers[0], "mlp")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(cls, seed, n=5):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 256, int(rng.integers(2, 21))).astype(np.int32),
                max_new=int(rng.integers(2, 7))) for i in range(n)]


@pytest.fixture(scope="module")
def jax_container():
    rt = JaxRuntime()
    yield rt.deploy(jax_make_bundle(MAMBA, reduced=True), mesh=make_host_mesh(data=1))
    rt.cleanup()


@pytest.fixture()
def torch_container():
    rt = Runtime(host_env={})
    yield rt.deploy(make_bundle(MAMBA, reduced=True), device="cpu")
    rt.cleanup()


@pytest.mark.parametrize("mode", ["contiguous", "paged", "decode-prefill"])
def test_mamba2_engine_tokens_identical_to_jax_engine(jax_container, torch_container, mode):
    kw = dict(slots=2, max_len=48, chunk=8)
    kw.update({"contiguous": {}, "paged": {"paged": True, "num_pages": 5},
               "decode-prefill": {"prefill_mode": "decode"}}[mode])
    jserver = JaxServer(jax_get_config(MAMBA).reduced(), jax_container, **kw)
    params = jax.tree.map(np.asarray, jserver.engine.params)
    tserver = Server(get_config(MAMBA).reduced(), torch_container, device="cpu",
                     params=params, **kw)
    seed = _seed("m-serve", mode)
    for server, cls in ((jserver, JaxRequest), (tserver, Request)):
        for r in _requests(cls, seed, n=5):
            assert server.submit(r)
        server.run()
    assert all(r.done for r in tserver.requests)
    assert [r.tokens for r in tserver.requests] == [r.tokens for r in jserver.requests]
    assert tserver.engine.prefill_calls == jserver.engine.prefill_calls
    assert tserver.engine.decode_calls == jserver.engine.decode_calls
    assert tserver.scheduler.consolidated_stats() == jserver.scheduler.consolidated_stats()


def _drain(sched, max_ticks=10_000):
    while not sched.idle:
        sched.tick()
        max_ticks -= 1
        assert max_ticks > 0, "scheduler failed to drain"


def test_jax_slot_export_continues_in_torch(jax_container, torch_container):
    """A JaxEngine prefills and exports each slot after its first token
    (``p0/state``, ``p0/conv``: the slot's rows); a TorchEngine adopts and
    imports it and decodes on: the tokens equal one engine serving all."""
    kw = dict(slots=2, max_len=48, chunk=8, paged=True)
    cfg = get_config(MAMBA).reduced()
    jserver = JaxServer(jax_get_config(MAMBA).reduced(), jax_container, **kw)
    params = jax.tree.map(np.asarray, jserver.engine.params)
    seed = _seed("m-handoff")
    whole = Server(cfg, torch_container, device="cpu", params=params, **kw)
    for r in _requests(Request, seed, n=4):
        whole.submit(r)
    whole.run()

    handoffs = []

    def export(req):
        arrays, pages_used = jserver.engine.export_slot(req.slot, req.next_pos)
        assert set(arrays) == {"p0/state", "p0/conv"}
        handoffs.append((req, arrays, pages_used))

    src = JaxScheduler(jserver.engine, on_handoff=export)
    reqs = _requests(JaxRequest, seed, n=4)
    for r in reqs:
        assert src.submit(r)
    _drain(src)
    assert src.handed_off == len(handoffs) > 0

    dst_engine = TorchEngine(cfg, torch_container, device="cpu", params=params, **kw)
    dst = Scheduler(dst_engine)
    adopted, pending = {}, list(handoffs)
    while pending or not dst.idle:
        if pending:
            req, arrays, pages_used = pending[0]
            item = Request(rid=req.rid, prompt=np.asarray(req.prompt, np.int32),
                           max_new=req.max_new, tokens=list(req.tokens),
                           next_pos=req.next_pos, order=req.order)
            if dst.adopt(item):
                dst_engine.import_slot(item.slot, arrays, pages_used)
                adopted[item.rid] = item
                pending.pop(0)
                continue
        dst.tick()
    got = [adopted[r.rid].tokens if r.rid in adopted else r.tokens for r in reqs]
    assert got == [r.tokens for r in whole.requests]


@pytest.mark.parametrize("flags", [[], ["--paged", "--window", "8"]],
                         ids=["contiguous", "paged-windowed"])
def test_cli_serves_mamba2_on_cpu(capsys, flags):
    assert serve_main(["--arch", MAMBA, "--device", "cpu", "--requests", "3",
                       "--max-new", "3", *flags]) == 0
    out = capsys.readouterr().out
    assert "container mamba2-780m-reduced" in out
    assert "served 3 requests / 9 tokens" in out and "device=cpu" in out


def test_deployment_lists_ssd_scan_as_ported_with_a_cuda_native():
    assert "ssd_scan" in PORTED_OPS
    reg = register_all()
    providers = {impl.provider: impl for impl in reg.decl("ssd_scan").impls}
    assert set(providers) == {"torch-ref", "cuda"}
    assert providers["cuda"].requires_feature == CUDA_KERNELS
    assert providers["cuda"].fn is ssd_scan and providers["torch-ref"].fn is ssd_scan_ref
    rt = Runtime(host_env={})
    container = rt.deploy(make_bundle(MAMBA, reduced=True), device="cpu")
    assert container.unported == ()
    report = {r.op: r for r in container.binding.reports}["ssd_scan"]
    assert report.bound == "torch-ref" and "'cuda'" in report.reason
    rt.cleanup()
