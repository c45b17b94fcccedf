#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (src/repro_torch) on one card and check it.

    python3 chip_smoke.py          # from the repository root, one Hopper card

Phases, each one printed line per case, each raising on failure:

  1. device  — the card's name, capability and memory, and nvidia-smi's
               name and power limit; anything but sm_90 fails.
  2. build   — builds the CUDA kernels from src/repro_torch/kernels/csrc.
  3. kernels — every CUDA kernel against its plain PyTorch version at the
               full qwen2.5-14b widths (moe_gmm, quant_matmul and ssd_scan
               at their models' shapes, phases 6-8), fp32 (TF32 off) and
               bf16, within TOLS (atol = rtol), with median times (CUDA
               events, L2 flushed between launches) of the kernel, the
               plain version and one PyTorch library call computing the
               same function;
               then the flash kernel's paged forms (shuffled tables over
               pools whose park page is poisoned, page 128 and page 16),
               windowed forms (W = 512; W >= kv_len bit-identical to no
               window) and paged + windowed forms (dead pages parked), each
               over a cache in q's dtype and over int8 and e4m3 caches with
               one fp32 scale a row (these also contiguous, and inside
               ATTN_ENVELOPE of the fp32 oracle on the unquantized cache;
               their library yardstick dequantizes the codes once at KV
               width and calls SDPA, with enable_gqa or over the heads
               expanded, whichever is faster), and the windowed_attention
               op; then the tensor-core kernel's edges (bf16 q, Sq = 17,
               the 36-row last chunk of request 0, 129 rows, the whole
               1316-token prompt, Dh = 64, a paged chunk at page 16
               bit-identical to the contiguous one, W >= kv_len, int8 and
               e4m3 caches; each also within EDGE_ROW_RTOL row by row, and
               on the tensor-core kernel as the library reports it) and
               then the split decode kernel's edges (bf16 q, one row a
               slot: pos 0, 63, 64, 127, 128 and 2047, B = 1 and 4 with a
               parked slot, a window starting inside a split, Dh = 64,
               page 16 and int8 / e4m3 caches each bit-identical to the
               contiguous launch, MHA-16; each within EDGE_ROW_RTOL, on the
               split decode kernel as the library reports it) and
               each flash instance's kernel, block and occupancy as the
               library and the CUDA runtime report them.
  4. model   — full width, 2 layers, fp32: logits of the CUDA binding
               against the plain binding for prefill, prefill_into with a
               partial last chunk, and decode with a parked slot.
  5. serve   — the main path: full qwen2.5-14b (48 layers, bf16, seeded
               random weights) through Runtime.deploy -> Server, 8 requests
               on 4 slots x 2048: run A contiguous, then one whole-prompt
               Model.prefill; run E contiguous with window 512; run B paged
               under memory pressure (25 pages: 24 usable of the 64 a full
               layout needs); run D paged with window 512 on 21 pages (the
               lease cap, 5 pages a request).  Launch counts are reset just
               before each run and read just after; each must have launched
               exactly the kernels its steps need; each attention run
               prints its flash launches by kernel as the library reported
               them at each launch, and fails unless its bf16 chunks of 128
               took the tensor-core kernel and its decode ticks the split
               decode kernel.  B's
               tokens must equal A's and D's E's.  The whole prefill
               through the plain binding is printed beside it for scale,
               both timed (host clock, synchronized, median of 3), and
               windowed_attention runs once through the deployed binding.
  6. quant   — the quantized-weight path, qwen2.5-14b with int8 or fp8
               weight codes and per-channel fp32 scales (its kernel cases
               run with phase 3): quant_matmul against quant_matmul_ref at
               the MLP and LM-head shapes (T = 4 decode, 128 a chunk, 1 the
               chunk's LM head, 1316 a whole prompt, 600 the model phase's
               prefill; bf16 x with T > 4 on the tensor-core kernel, whose
               row and column edges 129 and 256 rows cross), the
               quantization grid's ragged shapes (also inside QMM_ENVELOPE
               of the fp32 product) and three split contractions, fp32 and
               bf16 x, each launch pair torch.equal, and a byte table
               through an identity x (every code decodes exactly);
               then 2 layers fp32 in storage form, CUDA binding against
               plain for prefill (with where the two depart, printed),
               prefill_into and decode, and whole-prompt against chunked
               prefill; then full
               qwen2.5-14b with its seeded weights quantized on the card
               (15.19 GB of codes and scales): run Q8 int8 contiguous and
               one whole-prompt Model.prefill, run Q8P int8 paged on 25
               pages (its tokens must equal Q8's), run QF8 fp8 contiguous;
               every step launches quant_matmul 3 x 48 + 1 times (a
               prefill step's 3 x 48 on the tensor-core kernel, the rest
               on the narrow one: the kernels line counts each apart).
               The quantized KV cache (the flash kernel's quantized-KV
               form is held against its plain version with the other
               forms, phase 3): the 2-layer model phase again over a cache
               of the weights' format; then the same int8 and fp8 trees
               served with quantize= (the KV cache quantized too): run K8
               int8 contiguous, K8P int8 paged on 25 pages (its tokens
               must equal K8's), KF8 fp8 contiguous, each printing its
               share of K and V codes at the clip, its attention launches
               a step and its peak memory.
  7. moe     — the MoE path, the repo's moonshot-v1-16b-a3b config
               (Moonlight-16B-A3B's widths; its 48 layers and MHA 16/16
               are the repo's, not the published model's)
               (its kernel cases run with phase 3, before any model is
               built): the moe_gmm kernel against moe_gmm_exact at the expert
               shapes [64, 2048, 1408] and [64, 1408, 2048], fp32 and bf16,
               at T = 24 (decode, routed, empty experts), 768 (a 128-token
               chunk x top-6), 7896 (the whole prompt of request 0) and 768
               rows in one expert, each launch pair torch.equal, and on the
               kernel the library reported, which each case names: bf16
               with T >= E (64) on the tensor-core kernel, the rest on the
               FMA kernel; the tensor-core kernel's edges at both shapes
               (T = 64 at the cut and 63 below it, groups of 1, 16, 17, 64,
               65 and 129 rows, 300 rows in the last expert, sizes summing
               to 200 of T = 300 with the tail rows 0), each the same way,
               and again at w [64, 80, 136] and [64, 136, 24], whose D and
               F end inside a 64-wide k stage and a 128-column tile (the
               kernel's zero-fills past D and F and its partial last k
               step); chunk and
               decode attention at its H = KV = 16 geometry; then 2 layers
               fp32, CUDA binding against plain for prefill_into and decode
               (every call <= 1024 rows, where the plain binding is
               dropless) and the CUDA binding's whole-prompt prefill (1800
               rows) against its chunked prefill, with one MoE layer run under
               torch.cuda.set_sync_debug_mode("error"): it must read nothing
               back to the host; then full moonshot (48 layers, bf16, 57.8
               GB of seeded weights) serving the same 8 requests: run M
               contiguous, one whole-prompt Model.prefill (its 144 moe_gmm
               launches all on the tensor-core kernel; timed beside the
               plain binding's, host clock, synchronized, median of 3), and
               run MP paged on 25 pages.  MP's tokens must equal M's; every
               run launches exactly steps x 48 x 3 moe_gmm, steps x 48
               attention and steps x 97 rmsnorm, its prefill steps' moe_gmm
               all on the tensor-core kernel and its decode ticks' all on
               the FMA kernel, as the library reported them (_gmm_by_kernel).
  8. ssm     — the Mamba-2 path, mamba2-780m (its kernel cases run with
               phase 3): ssd_scan against ssd_scan_ref at H = 48, P = 64,
               N = 128 — the serve chunk (S = chunk = 128), the same with dt
               zero past row 37, the whole 1316-token prompt (chunk 4),
               B = 2 S = 2048 (16 carried chunks), 8 groups — fp32 and
               bf16, y and state within TOLS, each launch pair torch.equal,
               and at unit scale the kernel within UNIT_SCALE_RATIO times
               the plain version's distance to the recurrence in float64;
               then 2 layers fp32, CUDA binding against plain for prefill,
               prefill_into (128 + 128 + 44) and decode with a parked row
               whose state must stay bit-identical (limit SSM_MODEL_RTOL);
               then full mamba2-780m (48 layers, bf16, tied embeddings,
               1.56 GB of seeded weights) serving the same 8 requests: run
               S contiguous, one whole-prompt Model.prefill, run SP paged
               on 25 pages (SP's tokens must equal S's); every run launches
               exactly prefill steps x 48 ssd_scan (none in decode, which
               is plain code), steps x 49 rmsnorm and no attention.

The line before the last is the kernels JSON (a flash or moe_gmm entry
also gives its launches by kernel, as the library reported them); the
last line is
{"ok": true, "device": {...}}.  Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "qwen2.5-14b"
MOE_ARCH = "moonshot-v1-16b-a3b"
SSM_ARCH = "mamba2-780m"
GMM_PER_LAYER = 3   # w_gate, w_in, w_out: one moe_gmm launch each


def _qmm_per_step(layers: int) -> int:
    """quant_matmul launches a step of a quantized dense model: w_gate, w_in
    and w_out of every layer, and the LM head."""
    return 3 * layers + 1


def _qmm_by_kernel(run: dict, layers: int) -> dict:
    """A bf16 quantized serve run's quant_matmul launches by the kernel each
    took (quant_matmul.cu picks it by x's dtype and rows: the tensor-core
    kernel above 4 rows, the narrow one at 4 or fewer).  A prefill step's
    3 x layers MLP matmuls have the chunk's rows and its LM head the last
    token's one; a decode tick's matmuls have one row a slot."""
    (pre, dec), (chunk, slots) = run["steps"], run["rows"]
    if not slots <= 4 < chunk:
        fail("quant-serve", f"chunk {chunk} / {slots} slots: the kernel split below assumes "
                            f"a chunk of more than 4 rows and at most 4 slots")
    by_kernel = {"tensor_core": pre * 3 * layers, "narrow": pre + dec * _qmm_per_step(layers)}
    if sum(by_kernel.values()) != run["launches"]["quant_matmul"]:
        fail("quant-serve", f"quant_matmul launches {run['launches']['quant_matmul']} are not "
                            f"{by_kernel}")
    return by_kernel


def _flash_by_kernel(run: dict, op: str, want: str | None = None) -> dict:
    """A run's launches of flash op `op` by the kernel each took, as the
    library reported it at the launch (`_build.KERNEL_LAUNCHES`, reset
    with the op counts before the run and read just after).  Fails unless
    they add up to the op's count, or, with `want`, unless every one took
    the kernel `want`."""
    from repro_torch.kernels.flash_attention import KERNELS

    total = run["launches"].get(op, 0)
    by_kernel = {k: run["kernel_launches"].get((op, k), 0) for k in KERNELS}
    if sum(by_kernel.values()) != total:
        fail("serve", f"{op} launches {total} are not {by_kernel}")
    if want is not None and by_kernel[want] != total:
        fail("serve", f"{op} launches by kernel {by_kernel}: not all on the {want} kernel")
    return by_kernel


def _gmm_by_kernel(run: dict) -> dict:
    """A MoE serve run's moe_gmm launches by the kernel each took, as the
    library reported it at the launch, over its prefill steps and its
    decode ticks apart (`step_kernels`, counted around each step) and in
    all.  Fails unless they add up to the op's count, every prefill launch
    (a bf16 chunk of 128 tokens x top-6: at least E rows) took the
    tensor-core kernel and every decode launch (4 slots x top-6: fewer
    rows than experts) the FMA kernel."""
    from repro_torch.kernels.moe_gmm import KERNELS

    split = {kind: {k: run["step_kernels"][kind].get(("moe_gmm", k), 0) for k in KERNELS}
             for kind in ("prefill", "decode")}
    split["run"] = {k: split["prefill"][k] + split["decode"][k] for k in KERNELS}
    total = run["launches"].get("moe_gmm", 0)
    if sum(split["run"].values()) != total:
        fail("moe-serve", f"moe_gmm launches {total} are not {split['run']}")
    for kind, want in (("prefill", "tensor_core"), ("decode", "fma")):
        if split[kind][want] != sum(split[kind].values()):
            fail("moe-serve", f"moe_gmm {kind} launches by kernel {split[kind]}: not all on "
                              f"the {want} kernel")
    return split


SEED = 0
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}   # as tests/test_attention_conformance.py
POISON = 50.0       # park-page fill, as tests/test_attention_conformance.py
MAX_LEN = 2048      # the serve phase's slot length: 16 pages of 128
WINDOW = 512        # the windowed serve runs' and kernel cases' W
# the flash kernel's bf16 edge cases, beside TOLS: over every (batch,
# query, head) row, max |cuda - plain| / max |plain| over its Dh outputs,
# at most 4 bf16 ulps of the row's largest output.  TOLS's 2e-2 is half a
# typical output at 2000 keys; a 64-key tile, or a 128-key decode split,
# dropped or counted twice moves some row by far more than this limit
# (tests/test_torch_flash_tc.py and tests/test_torch_flash_decode.py plant
# both faults in the kernels' emulations)
EDGE_ROW_RTOL = 4 * 2.0 ** -7
MODEL_RTOL = 1e-3   # phase 4: max |cuda - plain| / max |plain| over the logits
SSM_MODEL_RTOL = 1e-4   # the SSM model phase's limit, the same measure
UNIT_SCALE_RATIO = 2.0  # ssd_scan at unit scale: kernel's / plain's distance to float64
# quant_matmul against the fp32 product of the unquantized weights, at the
# quantization grid's shapes (tests/test_quant_conformance.py): set for a
# D = 64 contraction, so held only there
QMM_ENVELOPE = {"int8": 0.35, "fp8": 1.50}
# quantized-KV attention against the fp32 oracle on the unquantized cache
# (tests/test_quant_conformance.py's ATTN_ENVELOPE)
ATTN_ENVELOPE = {"int8": 0.12, "fp8": 0.30}
QMM_GRID = [(8, 32, 32), (60, 64, 64), (7, 48, 32), (16, 32, 64)]
# ragged shapes whose contraction the wrapper splits (D = 1000: 16 steps of
# 64, the last 40 rows): the narrow tile (T <= 4) and the row tile with 5
# and with 5 of 32 rows live in the last tile
QMM_SPLIT = [(3, 1000, 48), (5, 1000, 48), (37, 1000, 144)]
# NVIDIA H100 SXM data sheet, dense: memory rate and peak operation rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32 = 67e12          # float32 outside the tensor cores (TF32 off)
PEAK_BF16_TC = 989e12      # bf16 on the tensor cores
SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:38"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:186"),
    "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:102"),
    "quant_matmul": ("src/repro_torch/kernels/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:45"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:91"),
}
STILL_TO_PORT: list[str] = []   # every TPU kernel form has its CUDA kernel


class PhaseError(RuntimeError):
    pass


def fail(phase: str, msg: str) -> None:
    raise PhaseError(f"[{phase}] FAIL: {msg}")


# --------------------------------------------------------------------------- #
# timing and bounds
# --------------------------------------------------------------------------- #
def time_ms(torch, fn, flush, iters: int = 20) -> float:
    """Median device time of fn() over `iters` launches (CUDA events), the
    L2 cache flushed before each: the main path meets every layer's
    weights and cache cold.  A spin of about 1 ms on the device before each
    start event lets the host enqueue fn's launches ahead of the device, so
    the host's launch overhead stays out of the device time."""
    fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _median_ms(torch, fn, n: int = 3) -> float:
    """Median host-clock time of fn() over n calls, each between device
    synchronizations."""
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ts)


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate for their type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attn_bound(b, sq, h, kv, dh, key_rows, pairs, esize, dtype_name, table_bytes=0,
               kv_esize=None):
    """q and o once, the key_rows K and V rows the data needs once (at
    kv_esize bytes an element, 1 for a quantized cache; default esize),
    and `table_bytes` more (a paged call's block table, a quantized call's
    scale rows); 2 * Dh multiply-adds per (query, key) pair for q.k and
    again for p.v."""
    kv_esize = esize if kv_esize is None else kv_esize
    nbytes = 2 * b * sq * h * dh * esize + 2 * key_rows * kv * dh * kv_esize + table_bytes
    ops = 4 * dh * pairs * h
    return bound_ms(nbytes, ops, PEAK_BF16_TC if dtype_name == "bfloat16" else PEAK_FP32)


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #
def phase_device(torch) -> None:
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    mem = torch.cuda.get_device_properties(0).total_memory
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {name} capability {cap} memory {mem} bytes, "
          f"{torch.cuda.device_count()} visible, torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(smi)
    if cap != (9, 0):
        fail("device", f"capability {cap}; the kernels are built for sm_90a")


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    dt = time.perf_counter() - t0
    print(f"[build] kernels built from {_build.CSRC.relative_to(ROOT)} into "
          f"{_build.BUILD_DIR.relative_to(ROOT)} in {dt:.1f} s")


def _check(phase, label, got, want, dtype_name) -> float:
    import torch

    tol = TOLS[dtype_name]
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(phase, f"{label}: max_abs_err {err:.3g} outside atol=rtol={tol}")
    return err


def _record(report, key, label, dtype_name, err, k_ms, p_ms, lib_ms, bnd, main_case):
    """Print one kernel case; keep it under `key` when it is the main-path
    case (bf16 at the serve geometry) of the kernels line."""
    b_ms, b_by = bnd
    print(f"[kernels] {key:<32} {label:<40} {dtype_name:<8} max_abs_err {err:.3g} "
          f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms library "
          f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} bound {b_ms:.4f} ms ({b_by})")
    if main_case:
        report[key] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def phase_kernels(torch, flush) -> dict:
    """Every kernel against its plain version; returns the main-path cases
    (bf16 at the serve geometry) keyed by op for the kernels line."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention_ref import chunk_attention_ref, decode_attention_ref
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.rmsnorm_ref import rmsnorm_ref

    cfg = get_config(ARCH)
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    group = h // kv
    smax = 2048
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    report = {}

    def record(op, label, dtype_name, err, k_ms, p_ms, lib_ms, bnd, main_case):
        _record(report, op, label, dtype_name, err, k_ms, p_ms, lib_ms, bnd, main_case)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        es = torch.empty((), dtype=dtype).element_size()

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        # rmsnorm: the chunk's 128 rows and the 4 decode slots of the serve
        # phase, plus 512 and 8 rows
        for rows in (512, 128, 8, 4):
            x, w = randn(rows, d), 1 + 0.1 * randn(d)
            err = _check("kernels", f"rmsnorm [{rows}, {d}]", rmsnorm(x, w), rmsnorm_ref(x, w), dn)
            record("rmsnorm", f"[{rows}, {d}]", dn, err,
                   time_ms(torch, lambda: rmsnorm(x, w), flush),
                   time_ms(torch, lambda: rmsnorm_ref(x, w), flush),
                   time_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-6), flush),
                   bound_ms((2 * rows * d + d) * es, 4 * rows * d, PEAK_FP32),
                   dn == "bfloat16" and rows == 128)

        # attention: whole-prompt causal prefill
        s = 2048
        q, k, v = randn(1, s, h, dh), randn(1, s, kv, dh), randn(1, s, kv, dh)
        err = _check("kernels", "attention", ops._cuda_attention(q, k, v, causal=True),
                     ops._ref_attention(q, k, v, causal=True), dn)
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(group, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(group, dim=2).transpose(1, 2)
        record("attention", f"B=1 S={s} causal", dn, err,
               time_ms(torch, lambda: ops._cuda_attention(q, k, v, causal=True), flush),
               time_ms(torch, lambda: ops._ref_attention(q, k, v, causal=True), flush),
               time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                       flush),
               attn_bound(1, s, h, kv, dh, s, s * (s + 1) // 2, es, dn), dn == "bfloat16")
        del q, k, v, qt, kt, vt

        # chunk_attention: C=128 queries against a 2048-slot cache
        c = 128
        kc, vc = randn(1, smax, kv, dh), randn(1, smax, kv, dh)
        kt = kc.repeat_interleave(group, dim=2).transpose(1, 2)
        vt = vc.repeat_interleave(group, dim=2).transpose(1, 2)
        for pos in (0, 384, 1900):
            q = randn(1, c, h, dh)
            err = _check("kernels", f"chunk_attention pos={pos}",
                         ops._cuda_chunk_attention(q, kc, vc, pos),
                         chunk_attention_ref(q, kc, vc, pos), dn)
            lim = pos + torch.arange(c, device="cuda")[:, None]
            mask = (torch.arange(smax, device="cuda")[None, :] <= lim)[None, None]
            qt = q.transpose(1, 2)
            record("chunk_attention", f"C={c} pos={pos} Smax={smax}", dn, err,
                   time_ms(torch, lambda: ops._cuda_chunk_attention(q, kc, vc, pos), flush),
                   time_ms(torch, lambda: chunk_attention_ref(q, kc, vc, pos), flush),
                   time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                         attn_mask=mask), flush),
                   attn_bound(1, c, h, kv, dh, pos + c, c * pos + c * (c + 1) // 2, es, dn),
                   dn == "bfloat16" and pos == 1900)
        del kc, vc, kt, vt

        # decode_attention: per-slot positions, the last slot parked at max_len-1
        for positions in ((0, 5, 127, 500, 1023, 1500, 2046, smax - 1),
                          (100, 700, 1600, smax - 1)):
            b = len(positions)
            pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
            q, kc, vc = randn(b, 1, h, dh), randn(b, smax, kv, dh), randn(b, smax, kv, dh)
            err = _check("kernels", f"decode_attention B={b}",
                         ops._cuda_decode_attention(q, kc, vc, pos),
                         decode_attention_ref(q, kc, vc, pos), dn)
            mask = (torch.arange(smax, device="cuda")[None, :] <= pos[:, None])[:, None, None]
            qt = q.transpose(1, 2)
            kt = kc.repeat_interleave(group, dim=2).transpose(1, 2)
            vt = vc.repeat_interleave(group, dim=2).transpose(1, 2)
            keys = sum(p + 1 for p in positions)
            record("decode_attention", f"B={b} Smax={smax} parked", dn, err,
                   time_ms(torch, lambda: ops._cuda_decode_attention(q, kc, vc, pos), flush),
                   time_ms(torch, lambda: decode_attention_ref(q, kc, vc, pos), flush),
                   time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                         attn_mask=mask), flush),
                   attn_bound(b, 1, h, kv, dh, keys, keys, es, dn),
                   dn == "bfloat16" and b == 4)
            del q, kc, vc, kt, vt
    return report


def _row_rel_err(got, want) -> float:
    """Max over the (..., Dh) rows of max |got - want| / max |want| over
    the row."""
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    return (diff / want.float().abs().amax(dim=-1).clamp_min(1e-30)).max().item()


def _flash_case(torch, flush, report, key, label, dn, cuda_fn, plain_fn, lib_fns, bnd,
                main_case, bitwise=None, envelope=None, row_rtol=None):
    """One flash-kernel case: cuda_fn() finite, within TOLS of plain_fn()
    and equal to itself on a second launch; with `row_rtol`, within it of
    plain_fn() row by row (`_row_rel_err`); with `bitwise` (two launches,
    by default one at W >= kv_len and its unwindowed counterpart, and
    optionally what their equality shows) the two bit-identical; with
    `envelope` ((oracle_fn, limit)) within `limit` of oracle_fn().  Then,
    with `lib_fns`, timed and recorded (`_record`), the library time the
    fastest of `lib_fns`; without, only its error is printed."""
    full = f"{key} {label}"
    got = cuda_fn()
    if not torch.isfinite(got.float()).all():
        fail("kernels", f"{full}: non-finite output on a live row")
    want = plain_fn()
    err = _check("kernels", full, got, want, dn)
    again = cuda_fn()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail("kernels", f"{full} {dn}: two launches differ")
    notes = ["two launches equal"]
    if row_rtol is not None:
        rel = _row_rel_err(got, want)
        if rel > row_rtol:
            fail("kernels", f"{full} {dn}: row-relative error {rel:.4g} above {row_rtol:.4g}")
        notes.append(f"row-relative error {rel:.4g} (limit {row_rtol:.4g})")
    if envelope is not None:
        env = (got.float() - envelope[0]().float()).abs().max().item()
        if env > envelope[1]:
            fail("kernels", f"{full} {dn}: {env:.4f} from the fp32 oracle, outside {envelope[1]}")
        notes.append(f"{env:.4f} from the fp32 oracle on the unquantized cache "
                     f"(envelope {envelope[1]})")
    if bitwise is not None:
        wide, plain = bitwise[0](), bitwise[1]()
        what = bitwise[2] if len(bitwise) > 2 else \
            "W >= kv_len bit-identical to the unwindowed launch"
        torch.cuda.synchronize()
        if not torch.equal(wide, plain):
            fail("kernels", f"{full}: not {what}")
        notes.append(what)
    if not lib_fns:
        print(f"[kernels] {key:<32} {label:<40} {dn:<8} max_abs_err {err:.3g}; "
              f"{'; '.join(notes)}")
        return
    lib_ms = [time_ms(torch, f, flush) for f in lib_fns]
    if len(lib_ms) > 1:
        notes.append("library routes " + " / ".join(f"{t:.4f}" for t in lib_ms) + " ms")
    print(f"[kernels] {key:<32} {label:<40} {dn:<8} {'; '.join(notes)}")
    _record(report, key, label, dn, err, time_ms(torch, cuda_fn, flush),
            time_ms(torch, plain_fn, flush), min(lib_ms), bnd, main_case)


def _quantize_rows(torch, x, fmt: str):
    """Codes of a (B, S, KV, Dh) cache with one amax scale a batch row (as
    tests/test_quant_conformance.py quantizes its grid), written by the
    model's cache write `quant_update`: (codes, (B,) float32 scales)."""
    from repro_torch.kernels.quant import FP8_MAX, INT8_MAX, storage_dtype
    from repro_torch.models.layers import quant_update

    top = INT8_MAX if fmt == "int8" else FP8_MAX
    scale = x.float().abs().amax(dim=(1, 2, 3)).clamp_min(1e-6) / top
    return quant_update(x, scale, storage_dtype(fmt)), scale


def _paged_pool(torch, cache, page, last, seed):
    """Page pools (P, page, KV, Dh) holding a (B, S, KV, Dh) cache's blocks
    on shuffled pages, and the block table: row b maps the blocks its
    positions 0..last[b] touch to their pages, the rest to the park page
    0, which holds POISON in the cache's dtype (a 1-byte cache: its code)."""
    b, s = cache.shape[:2]
    n = s // page
    perm = torch.randperm(b * n, generator=torch.Generator().manual_seed(seed)) + 1
    table = perm.reshape(b, n).to(torch.int32)
    pool = torch.empty((1 + b * n, page) + tuple(cache.shape[2:]), dtype=cache.dtype,
                       device=cache.device)
    pool[0] = torch.full(tuple(pool.shape[1:]), POISON, device=cache.device).to(cache.dtype)
    pool[table.reshape(-1).long().cuda()] = cache.reshape(b * n, page, *cache.shape[2:])
    for row, p in enumerate(last):
        table[row, p // page + 1:] = 0
    return pool, table.cuda()


def _gathered(pool, table):
    """The logical (B, S, KV, Dh) cache a block table addresses in a pool."""
    b, n = table.shape
    return pool[table.long()].reshape(b, n * pool.shape[1], *pool.shape[2:])


def _library(torch, qt, k, v, scales, mask, group) -> tuple:
    """The library yardsticks of a flash case over the logical cache k, v
    (B, S, KV, Dh), a paged case's pages gathered outside the timing.  In
    q's dtype: SDPA over the KV heads expanded outside the timing.  A 1-byte
    cache: the codes dequantized once, at KV width, to q's dtype inside the
    timing, then SDPA with enable_gqa=True, or SDPA over the dequantized
    heads expanded (repeat_interleave); `_flash_case` keeps the faster."""
    import torch.nn.functional as F

    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if not scales:
        kx, vx = (x.repeat_interleave(group, dim=1) for x in (kt, vt))
        return (lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=mask),)
    ks, vs = (s.view(-1, 1, 1, 1) for s in scales)

    def dequantized():
        return (kt.float() * ks).to(qt.dtype), (vt.float() * vs).to(qt.dtype)

    def gqa():
        kd, vd = dequantized()
        return F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask, enable_gqa=True)

    def expanded():
        kd, vd = dequantized()
        return F.scaled_dot_product_attention(qt, kd.repeat_interleave(group, dim=1),
                                              vd.repeat_interleave(group, dim=1),
                                              attn_mask=mask)
    return gqa, expanded


def _key_work(limits, window) -> tuple[int, int]:
    """(K/V rows, (query, key) pairs) that causal queries need: `limits`
    holds each batch row's list of query positions."""
    rows = pairs = 0
    for lims in limits:
        low = 0 if window is None else max(0, min(lims) - window + 1)
        rows += max(lims) + 1 - low
        pairs += sum(p + 1 if window is None else min(window, p + 1) for p in lims)
    return rows, pairs


def phase_kernel_forms(torch, flush) -> dict:
    """The flash kernel's forms beyond phase 3's at qwen's serve shapes,
    against their plain versions, for each K/V format: the cache in q's own
    dtype, and int8 / e4m3 codes with one fp32 scale a batch row (written
    by the model's cache write).  Decode B = 4 at positions
    100/700/1600/2047, chunks of C = 128 at position 1792: windowed (W =
    512; W >= kv_len bit-identical to no window), paged (shuffled tables,
    park page poisoned; page 128, and 16 for decode) and paged + windowed
    (dead pages parked).  A quantized cache also contiguous (the chunk at
    1900 and 1792), and inside ATTN_ENVELOPE of the fp32 oracle on the
    unquantized cache.  Then the windowed_attention op.  q fp32 and bf16;
    every launch pair bit-identical.  Returns the main-path cases (bf16;
    page 128; the contiguous chunk at 1900) keyed by form."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention_ref import (
        chunk_attention_ref,
        decode_attention_ref,
        windowed_attention_ref,
    )

    cfg = get_config(ARCH)
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    group = h // kv
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    report = {}
    positions = (100, 700, 1600, MAX_LEN - 1)
    c = 128
    ki = torch.arange(MAX_LEN, device="cuda")
    refs = {"decode_attention": decode_attention_ref, "chunk_attention": chunk_attention_ref}

    def forms(op, q, k, v, fmt, ats, pages, dn, es):
        """Every form of `op` for q over the unquantized cache k, v (B,
        MAX_LEN, KV, Dh), stored in q's dtype or as `fmt` codes: a 1-byte
        cache contiguous at each position in `ats`, then at the last of
        them windowed, and for each page size paged and paged + windowed."""
        cuda, ref = getattr(ops, f"_cuda_{op}"), refs[op]
        b, sq = q.shape[:2]
        qt = q.transpose(1, 2)
        if fmt is None:
            kc, vc, sc, sb = k, v, (), 0
        else:
            (kc, ks), (vc, vs) = _quantize_rows(torch, k, fmt), _quantize_rows(torch, v, fmt)
            sc, sb = (ks, vs), 2 * 4 * b                  # the two scale rows

        def limits(at):
            if isinstance(at, int):
                return [[at + i for i in range(sq)] for _ in range(b)]
            return [[p] for p in at.tolist()]

        def one(form, label, at, kk, vv, table=None, window=None, parked=None, main=True):
            """One case; the windowed call reads `parked` where given (its
            dead blocks on the park page), the W >= kv_len launch `table`."""
            tab = table if parked is None else parked
            lims = limits(at)
            lim = torch.tensor(lims, device="cuda")[..., None]
            mask = ki <= lim
            if window is not None:
                mask = mask & (ki > lim - window)
            rows, pairs = _key_work(lims, window)
            logical = (kk, vv) if table is None else (_gathered(kk, table), _gathered(vv, table))
            tb = 0 if table is None else table.numel() * 4
            key = f"{op}/" + "+".join(([f"kv_{fmt}"] if fmt else []) + ([form] if form else []))
            _flash_case(
                torch, flush, report, key, f"{'B=4' if sq == 1 else f'C={c} pos={at}'} {label}",
                dn, lambda: cuda(q, kk, vv, at, tab, window, *sc),
                lambda: ref(q, kk, vv, at, tab, window, *sc),
                _library(torch, qt, *logical, sc, mask[:, None], group),
                attn_bound(b, sq, h, kv, dh, rows, pairs, es, dn, tb + sb,
                           kv_esize=1 if fmt else None),
                dn == "bfloat16" and main,
                bitwise=None if window is None else (
                    lambda: cuda(q, kk, vv, at, table, 2 * MAX_LEN, *sc),
                    lambda: cuda(q, kk, vv, at, table, None, *sc)),
                envelope=None if fmt is None else (
                    lambda: ref(q.float(), k.float(), v.float(), at, None, window),
                    ATTN_ENVELOPE[fmt]))

        for at in ats if fmt else ():
            one("", f"Smax={MAX_LEN}", at, kc, vc, main=at is ats[0])
        at = ats[-1]
        lims = limits(at)
        one("windowed", f"W={WINDOW} Smax={MAX_LEN}", at, kc, vc, window=WINDOW)
        for page in pages:
            pk, table = _paged_pool(torch, kc, page, [max(x) for x in lims], SEED + page)
            pv, _ = _paged_pool(torch, vc, page, [max(x) for x in lims], SEED + page)
            parked = table.clone()
            for row, x in enumerate(lims):
                parked[row, :max(0, min(x) - WINDOW) // page] = 0
            one("paged", f"page={page} P={pk.shape[0]}", at, pk, pv, table, main=page == 128)
            one("paged+windowed", f"page={page} W={WINDOW} dead parked", at, pk, pv, table,
                WINDOW, parked, main=page == 128)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        es = torch.empty((), dtype=dtype).element_size()

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        for fmt in (None, "int8", "fp8"):
            pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
            forms("decode_attention", randn(4, 1, h, dh), randn(4, MAX_LEN, kv, dh),
                  randn(4, MAX_LEN, kv, dh), fmt, (pos,), (128, 16), dn, es)
            forms("chunk_attention", randn(1, c, h, dh), randn(1, MAX_LEN, kv, dh),
                  randn(1, MAX_LEN, kv, dh), fmt, (1900, 1792), (128,), dn, es)

        # windowed_attention: whole-prompt sliding-window prefill
        s = MAX_LEN
        q, k, v = randn(1, s, h, dh), randn(1, s, kv, dh), randn(1, s, kv, dh)
        smask = ((ki[None, :] <= ki[:, None]) & (ki[None, :] > ki[:, None] - WINDOW))[None, None]
        spairs = sum(min(WINDOW, i + 1) for i in range(s))
        _flash_case(torch, flush, report, "windowed_attention", f"B=1 S={s} W={WINDOW}", dn,
                    lambda: ops._cuda_windowed_attention(q, k, v, WINDOW),
                    lambda: windowed_attention_ref(q, k, v, WINDOW),
                    _library(torch, q.transpose(1, 2), k, v, (), smask, group),
                    attn_bound(1, s, h, kv, dh, s, spairs, es, dn), dn == "bfloat16",
                    bitwise=(lambda: ops._cuda_windowed_attention(q, k, v, 2 * s),
                             lambda: ops._cuda_attention(q, k, v, causal=True)))
        del q, k, v
    return report


def phase_kernel_edges(torch, flush) -> None:
    """The flash kernel's bf16 launches at their edges, at qwen's heads.
    The tensor-core kernel: Sq = 17 (the first launch it takes), the 36-row
    last chunk of request 0's 1316 tokens, 129 rows and the whole 1316-token
    prompt (neither a multiple of the 64-row block), Dh = 64, a paged chunk
    at page 16 (a 64-key tile spans 4 pages), a windowed chunk with W >=
    kv_len (bit-identical to the unwindowed launch), and int8 and e4m3
    caches at 17 and 36 rows (inside ATTN_ENVELOPE of the fp32 oracle on
    the unquantized cache).  The split decode kernel (`_decode_edges`).
    Each within TOLS and EDGE_ROW_RTOL of its plain version, its two
    launches torch.equal, every launch on its kernel as the library reports
    it.  Then the kernel, block and occupancy of each instance as the
    library and the CUDA runtime report them."""
    import collections

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention import occupancy
    from repro_torch.kernels.flash_attention_ref import chunk_attention_ref

    cfg = get_config(ARCH)
    h, kv = cfg.num_heads, cfg.num_kv_heads
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    dn, bf16 = "bfloat16", torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    def edge(key, label, q, cuda_fn, plain_fn, kernel="tensor_core", **kw):
        before = collections.Counter(_build.KERNEL_LAUNCHES)
        _flash_case(torch, flush, {}, key, label, dn, cuda_fn, plain_fn, (), None, False,
                    row_rtol=EDGE_ROW_RTOL, **kw)
        took = collections.Counter(_build.KERNEL_LAUNCHES) - before
        if not took or any(k != kernel for _, k in took):
            fail("kernels", f"{key} {label}: launches by (op, kernel) {dict(took)}, not all "
                            f"on the {kernel} kernel")

    for dh in (cfg.head_dim, 64):
        for s in (17, 129, 1316):
            q, k, v = randn(1, s, h, dh), randn(1, s, kv, dh), randn(1, s, kv, dh)
            edge("attention/edge", f"S={s} Dh={dh}", q,
                 lambda: ops._cuda_attention(q, k, v, causal=True),
                 lambda: ops._ref_attention(q, k, v, causal=True))
        kc, vc = randn(1, MAX_LEN, kv, dh), randn(1, MAX_LEN, kv, dh)
        for c, pos in ((17, 500), (36, 1280), (129, 700), (128, 1900)):
            q = randn(1, c, h, dh)
            edge("chunk_attention/edge", f"C={c} pos={pos} Dh={dh}", q,
                 lambda: ops._cuda_chunk_attention(q, kc, vc, pos),
                 lambda: chunk_attention_ref(q, kc, vc, pos),
                 bitwise=(lambda: ops._cuda_chunk_attention(q, kc, vc, pos, None, 2 * MAX_LEN),
                          lambda: ops._cuda_chunk_attention(q, kc, vc, pos)))
        q, at = randn(1, 128, h, dh), 1900
        pk, table = _paged_pool(torch, kc, 16, [at + 127], SEED + 16)
        pv, _ = _paged_pool(torch, vc, 16, [at + 127], SEED + 16)
        edge("chunk_attention/edge", f"C=128 pos={at} paged page=16 Dh={dh}", q,
             lambda: ops._cuda_chunk_attention(q, pk, pv, at, table),
             lambda: chunk_attention_ref(q, pk, pv, at, table),
             bitwise=(lambda: ops._cuda_chunk_attention(q, pk, pv, at, table),
                      lambda: ops._cuda_chunk_attention(q, kc, vc, at),
                      "bit-identical to the contiguous launch"))
        kf, vf = kc.float(), vc.float()
        for fmt in ("int8", "fp8"):
            (qk, ks), (qv, vs) = _quantize_rows(torch, kc, fmt), _quantize_rows(torch, vc, fmt)
            for c, pos in ((17, 500), (36, 1280)):
                q = randn(1, c, h, dh)
                edge(f"chunk_attention/edge+kv_{fmt}", f"C={c} pos={pos} Dh={dh}", q,
                     lambda: ops._cuda_chunk_attention(q, qk, qv, pos, None, None, ks, vs),
                     lambda: chunk_attention_ref(q, qk, qv, pos, None, None, ks, vs),
                     envelope=(lambda: chunk_attention_ref(q.float(), kf, vf, pos),
                               ATTN_ENVELOPE[fmt]))
        del kc, vc, kf, vf
    _decode_edges(torch, randn, edge)
    for dtype, kv_dtype, sq in ((bf16, bf16, 128), (bf16, torch.int8, 128),
                                (bf16, torch.float8_e4m3fn, 128), (bf16, bf16, 17),
                                (bf16, bf16, 16), (bf16, bf16, 1), (bf16, torch.int8, 1),
                                (bf16, torch.float8_e4m3fn, 1),
                                (torch.float32, torch.float32, 128),
                                (torch.float32, torch.float32, 1)):
        for dh in (cfg.head_dim, 64):
            for paged in (False, True):
                kind, rows, threads, resident = occupancy(dtype, kv_dtype, dh, sq, paged=paged)
                what = "query heads" if kind == "split_decode" else "query rows"
                print(f"[kernels] flash_attention occupancy q {dtype} cache {kv_dtype} Sq={sq} "
                      f"Dh={dh}{' paged' if paged else ''}: {kind} kernel, blocks of {rows} "
                      f"{what} and {threads} threads, {resident} resident an SM (CUDA runtime)")


def _decode_edges(torch, randn, edge) -> None:
    """The split decode kernel's edges (bf16 q, one row a slot), at qwen's
    heads and Dh 128 and 64: B = 1 at pos 0, 63, 64, 127, 128 and 2047
    (tile and split boundaries, the last slot), each with W >= kv_len
    bit-identical to no window; B = 4 with a parked slot (pos MAX_LEN - 1),
    a window of 200 (its start inside a split), a paged launch at page 16
    bit-identical to the contiguous one, and int8 and e4m3 caches (inside
    ATTN_ENVELOPE of the fp32 oracle, their page-16 launch bit-identical to
    the contiguous one); the causal launches of one row (`_causal_row_edges`);
    then MHA-16 (moonshot's H = KV = 16).  Every launch on the split decode
    kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention_ref import decode_attention_ref

    cuda, ref = ops._cuda_decode_attention, decode_attention_ref
    cfg = get_config(ARCH)
    h, kv = cfg.num_heads, cfg.num_kv_heads

    def pos_row(*positions):
        return torch.tensor(positions, dtype=torch.int32, device="cuda")

    def case(key, label, q, kk, vv, at, table=None, window=None, scales=(), contiguous=None,
             oracle=None):
        """One decode edge: with `contiguous` ((k, v) of the logical cache)
        the launch must equal the contiguous one; else, unwindowed, W >=
        kv_len must equal it."""
        if contiguous is not None:
            bitwise = (lambda: cuda(q, kk, vv, at, table, window, *scales),
                       lambda: cuda(q, *contiguous, at, None, window, *scales),
                       "bit-identical to the contiguous launch")
        elif window is None:
            bitwise = (lambda: cuda(q, kk, vv, at, table, 2 * MAX_LEN, *scales),
                       lambda: cuda(q, kk, vv, at, table, None, *scales))
        else:
            bitwise = None
        edge(key, label, q, lambda: cuda(q, kk, vv, at, table, window, *scales),
             lambda: ref(q, kk, vv, at, table, window, *scales), kernel="split_decode",
             bitwise=bitwise, envelope=oracle)

    for dh in (cfg.head_dim, 64):
        kc, vc = randn(4, MAX_LEN, kv, dh), randn(4, MAX_LEN, kv, dh)
        for pos in (0, 63, 64, 127, 128, MAX_LEN - 1):
            q = randn(1, 1, h, dh)
            case("decode_attention/edge", f"B=1 pos={pos} Dh={dh}", q, kc[:1], vc[:1],
                 pos_row(pos))
        positions = (63, 128, 1500, MAX_LEN - 1)
        at, q = pos_row(*positions), randn(4, 1, h, dh)
        case("decode_attention/edge", f"B=4 pos={positions} (last parked) Dh={dh}", q, kc, vc,
             at)
        case("decode_attention/edge", f"B=4 W=200 Dh={dh}", q, kc, vc, at, window=200)
        pk, table = _paged_pool(torch, kc, 16, positions, SEED + 16)
        pv, _ = _paged_pool(torch, vc, 16, positions, SEED + 16)
        case("decode_attention/edge", f"B=4 paged page=16 Dh={dh}", q, pk, pv, at, table,
             contiguous=(kc, vc))
        kf, vf = kc.float(), vc.float()
        for fmt in ("int8", "fp8"):
            (qk, ks), (qv, vs) = _quantize_rows(torch, kc, fmt), _quantize_rows(torch, vc, fmt)
            oracle = (lambda: ref(q.float(), kf, vf, at), ATTN_ENVELOPE[fmt])
            case(f"decode_attention/edge+kv_{fmt}", f"B=4 Dh={dh}", q, qk, qv, at,
                 scales=(ks, vs), oracle=oracle)
            pk, table = _paged_pool(torch, qk, 16, positions, SEED + 16)
            pv, _ = _paged_pool(torch, qv, 16, positions, SEED + 16)
            case(f"decode_attention/edge+kv_{fmt}", f"B=4 paged page=16 Dh={dh}", q, pk, pv,
                 at, table, scales=(ks, vs), contiguous=(qk, qv), oracle=oracle)
        _causal_row_edges(torch, randn, edge, h, kc, vc, at, positions)
        del kc, vc, kf, vf, pk, pv
    mcfg = get_config(MOE_ARCH)
    mh, mkv, mdh = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim
    kc, vc = randn(4, MAX_LEN, mkv, mdh), randn(4, MAX_LEN, mkv, mdh)
    case("decode_attention/edge+mha16", f"B=4 H=KV={mh} Dh={mdh}", randn(4, 1, mh, mdh), kc, vc,
         pos_row(100, 700, 1600, MAX_LEN - 1))


def _causal_row_edges(torch, randn, edge, h, kc, vc, at, positions) -> None:
    """The causal bf16 launches of one row, which take the split decode
    kernel as decode does: `attention` on a 1-token prompt (the static
    diagonal, q_start = Sk - 1 = 0) and `windowed_attention` at S = 1, at
    B = 4; a 1-row `chunk_attention` at the (B,) positions `at`, and a
    causal limit below kv_len (kv_len = Sk, q_start = `at`: the causal mask
    ends each row's keys), both bit-identical to the decode launch at the
    same positions.  `kc`/`vc`: (B, Sk, KV, Dh) bf16 caches."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_ref import chunk_attention_ref, masked_attention_ref

    b, sk, kv, dh = kc.shape
    q1, k1, v1 = randn(b, 1, h, dh), randn(b, 1, kv, dh), randn(b, 1, kv, dh)
    edge("attention/edge", f"S=1 B={b} Dh={dh}", q1,
         lambda: ops._cuda_attention(q1, k1, v1, causal=True),
         lambda: ops._ref_attention(q1, k1, v1, causal=True), kernel="split_decode")
    edge("windowed_attention/edge", f"S=1 B={b} W={WINDOW} Dh={dh}", q1,
         lambda: ops._cuda_windowed_attention(q1, k1, v1, WINDOW),
         lambda: ops._ref_windowed_attention(q1, k1, v1, WINDOW), kernel="split_decode")
    q = randn(b, 1, h, dh)

    def decode():
        return ops._cuda_decode_attention(q, kc, vc, at)

    edge("chunk_attention/edge", f"C=1 pos={positions} Dh={dh}", q,
         lambda: ops._cuda_chunk_attention(q, kc, vc, at),
         lambda: chunk_attention_ref(q, kc, vc, at), kernel="split_decode",
         bitwise=(lambda: ops._cuda_chunk_attention(q, kc, vc, at), decode,
                  "bit-identical to the decode launch"))
    full = torch.full((b,), sk, dtype=torch.int32, device=kc.device)
    edge("chunk_attention/edge", f"C=1 q_start={positions} kv_len={sk} Dh={dh}", q,
         lambda: flash_attention(q, kc, vc, full, at, causal=True, op="chunk_attention"),
         lambda: masked_attention_ref(q, kc, vc, full, at, causal=True, scale=dh ** -0.5),
         kernel="split_decode",
         bitwise=(lambda: flash_attention(q, kc, vc, full, at, causal=True,
                                          op="chunk_attention"), decode,
                  "bit-identical to the decode launch at kv_len = q_start + 1"))


def _rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def _model_pair(torch, arch: str, cfg, *, init: bool = True, kv_quantize: str | None = None):
    """Two models of `cfg` on the card (with a `kv_quantize` cache), one
    bound to the CUDA kernels and one to the plain versions; with `init`,
    the CUDA one drawn from SEED and the plain one loaded with its
    weights."""
    from repro_torch.core.runtime import Runtime
    from repro_torch.launch.bundle import make_bundle
    from repro_torch.models.model import Model

    runtime = Runtime()
    bindings = []
    for native in (True, False):
        bindings.append(runtime.deploy(make_bundle(arch), device="cuda",
                                       native_ops=native).binding)
        runtime.cleanup()
    m_cuda, m_plain = (Model(cfg, b, device="cuda", kv_quantize=kv_quantize) for b in bindings)
    if init:
        m_cuda.init(torch.Generator(device="cuda").manual_seed(SEED))
        m_plain.load_params(dict(m_cuda.named_parameters()))
    return m_cuda, m_plain


def _logit_check(torch, tag: str, limit: float, width: int | None = None):
    """compare(label, cuda, plain): the logits' largest difference over max
    |plain| (their first `width` columns), printed; fails past `limit` or
    on a non-finite logit."""
    def compare(label, a, b):
        a, b = a[..., :width], b[..., :width]
        rel = _rel(a, b)
        print(f"[{tag}] {label:<44} logits {tuple(a.shape)} max|cuda-plain|/max|plain| "
              f"{rel:.3g} (limit {limit})")
        if not bool(torch.isfinite(a).all()) or rel > limit:
            fail(tag, f"{label}: relative error {rel:.3g} (or non-finite logits)")
    return compare


def _prefill_chunks(np, caches: dict, prompt, slot: int, chunk: int):
    """prefill_into each model's cache (`caches`: model -> cache) at `slot`
    with `prompt` in chunks of `chunk`, the last one partial; returns (start,
    live tokens, {model: logits}) for each chunk."""
    steps = []
    for start in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - start)
        buf = np.zeros((1, chunk), np.int64)
        buf[0, :n] = prompt[start:start + n]
        steps.append((start, n, {m: m.prefill_into(buf, caches[m], slot, start, n)[0]
                                 for m in caches}))
    return steps


def phase_model(torch) -> None:
    from repro_torch.configs import get_config

    import numpy as np

    cfg = dataclasses.replace(get_config(ARCH), num_layers=2, dtype="float32")
    m_cuda, m_plain = _model_pair(torch, ARCH, cfg)
    rng = np.random.default_rng(SEED)
    compare = _logit_check(torch, "model", MODEL_RTOL)

    tokens = rng.integers(0, cfg.vocab_size, (2, 300))
    compare("prefill B=2 S=300", m_cuda.prefill({"tokens": tokens})[0],
            m_plain.prefill({"tokens": tokens})[0])

    slots, max_len, chunk, slot = 3, 512, 128, 1
    prompt = rng.integers(0, cfg.vocab_size, 300)
    caches = {m: m.init_cache(slots, max_len) for m in (m_cuda, m_plain)}
    _, _, out = _prefill_chunks(np, caches, prompt, slot, chunk)[-1]
    compare(f"prefill_into slot {slot}, 300 = 128+128+44", out[m_cuda], out[m_plain])

    whole = {m: m.prefill({"tokens": prompt[None]})[0] for m in caches}
    for m, name in ((m_cuda, "cuda"), (m_plain, "plain")):
        rel = _rel(out[m], whole[m])
        print(f"[model] {name} binding: prefill_into vs whole-prompt prefill, max rel "
              f"diff {rel:.3g} (limit {MODEL_RTOL})")
        if rel > MODEL_RTOL:
            fail("model", f"{name}: chunked prefill disagrees with whole-prompt prefill")

    token = rng.integers(0, cfg.vocab_size, (slots, 1))
    pos = np.array([5, len(prompt), max_len - 1], np.int32)
    out = {m: m.decode(token, caches[m], pos)[0] for m in caches}
    compare("decode pos [5, 300, 511 parked]", out[m_cuda], out[m_plain])


def _requests(np, cfg):
    """The serve phase's 8 seeded requests: prompts of 64-1536 tokens, 32 new."""
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(SEED)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(64, 1537))).astype(np.int32),
                    max_new=32) for i in range(8)]


def _drive(torch, np, cfg, container, label, *, params=None, **engine_kw) -> dict:
    """Serve the 8 requests through a Server on `container` with the given
    engine options (and `params`, a weight tree on the card, or else the
    seeded init), its launch counts reset just before `server.run()` and
    read just after; fails unless every request finished with finite logits
    and the run launched exactly the kernels its steps need."""
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import Server
    from repro_torch.models.layers import is_quantized

    t0 = time.perf_counter()
    server = Server(cfg, container, slots=4, max_len=MAX_LEN, chunk=128, device="cuda",
                    seed=SEED, params=params, **engine_kw)
    torch.cuda.synchronize()
    eng = server.engine
    by_dtype = {}
    for p in eng.model.parameters():
        key = str(p.dtype).removeprefix("torch.")
        by_dtype[key] = by_dtype.get(key, 0) + p.numel() * p.element_size()
    quantized = hasattr(eng.model, "lm_head") and is_quantized(eng.model.lm_head["w"])
    print(f"[serve] {label}: {cfg.name}, {cfg.num_layers} layers, "
          f"{'storage-form weights given' if quantized else 'seeded init'} in "
          f"{time.perf_counter() - t0:.1f} s, bound weight bytes {sum(by_dtype.values())} "
          f"{by_dtype}, engine options {engine_kw or 'none (contiguous)'}")

    nonfinite = []
    step_s = {"prefill": [], "decode": []}   # host clock per step; each step ends
    prefill_step, decode_step = eng.prefill_step, eng.decode_step   # in a device sync
    # launches by (op, kernel) as the library reported them, over the
    # prefill steps and the decode ticks apart (counted outside the clock)
    step_kernels = {"prefill": collections.Counter(), "decode": collections.Counter()}

    def count_since(kind, before):
        for key, n in _build.KERNEL_LAUNCHES.items():
            step_kernels[kind][key] += n - before.get(key, 0)

    def checked_prefill(slot, tokens, pos):
        before = dict(_build.KERNEL_LAUNCHES)
        t = time.perf_counter()
        out = prefill_step(slot, tokens, pos)
        step_s["prefill"].append(time.perf_counter() - t)
        count_since("prefill", before)
        if not np.isfinite(out).all():
            nonfinite.append(("prefill", slot, pos))
        return out

    def checked_decode(tokens, pos, active):
        before = dict(_build.KERNEL_LAUNCHES)
        t = time.perf_counter()
        out = decode_step(tokens, pos, active)
        step_s["decode"].append(time.perf_counter() - t)
        count_since("decode", before)
        # parked rows' logits are garbage by contract: check the live ones
        if out.shape != (eng.slots, eng.model.padded_vocab) or not np.isfinite(out[active]).all():
            nonfinite.append(("decode", tuple(pos)))
        return out

    eng.prefill_step, eng.decode_step = checked_prefill, checked_decode
    reqs = _requests(np, cfg)
    _build.clear_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        if not server.submit(r):
            fail("serve", f"{label}: request {r.rid} (prompt {r.prompt_len}) rejected")
    server.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)   # the run's launches, read just after it
    kernel_launches = dict(_build.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = (eng.prefill_calls, eng.decode_calls)
    # drop the checking wrappers: they close over the engine, and the cycle
    # would keep its weights (29.5 or 57.8 GB) alive after the run
    del eng.prefill_step, eng.decode_step

    tokens = sum(len(r.tokens) for r in reqs)
    ttfts = sorted(r.ttft for r in reqs)
    stats = server.scheduler.consolidated_stats()
    print(f"[serve] {label}: prompts {[r.prompt_len for r in reqs]}, max_new 32: "
          f"{sum(r.done for r in reqs)}/{len(reqs)} done, {tokens} tokens in {dt:.2f} s = "
          f"{tokens / dt:.1f} tokens/s")
    print(f"[serve] {label}: TTFT p50 {ttfts[len(ttfts) // 2] * 1e3:.1f} ms max "
          f"{ttfts[-1] * 1e3:.1f} ms | steps prefill={steps[0]} decode={steps[1]} | peak "
          f"memory {peak} bytes | peak active {int(stats['peak-active'])}, ticks "
          f"{int(stats['ticks'])}")
    if eng.paged:
        print(f"[serve] {label}: page pool {eng.pool.num_pages} pages x {eng.pool.page_size} "
              f"(park + {int(stats['pages-capacity'])}), allocated peak "
              f"{int(stats['pages-allocated-peak'])}, mean allocated "
              f"{stats['pages-allocated-mean']:.2f} / written {stats['pages-written-mean']:.2f}")
    median_ms = {}
    for kind, n in (("prefill", steps[0]), ("decode", steps[1])):
        ts = sorted(step_s[kind][:n])
        median_ms[kind] = ts[len(ts) // 2] * 1e3
        print(f"[serve] {label}: {kind} step (host clock, to logits on the host): median "
              f"{median_ms[kind]:.1f} ms, max {ts[-1] * 1e3:.1f} ms over {n} steps, "
              f"{sum(ts):.2f} s in all")
    print(f"[serve] {label}: launches in the serve run ({steps[0]} prefill + {steps[1]} "
          f"decode steps): {launches}")
    if not all(r.done and len(r.tokens) == r.max_new for r in reqs):
        fail("serve", f"{label}: not every request finished with max_new tokens")
    if nonfinite:
        fail("serve", f"{label}: non-finite or misshapen logits at {nonfinite[:4]}")
    # every launch of the run is one of its steps' ops: a layer's attention
    # per step, 2 norms per layer plus the final one, a MoE layer's three
    # grouped matmuls, and with quantized weights a dense layer's three MLP
    # matmuls plus the LM head; a Mamba-2 layer's one norm and, in a
    # prefill step only, its scan (decode updates the state in plain code)
    n = cfg.num_layers
    if cfg.family == "ssm":
        want = {"rmsnorm": (steps[0] + steps[1]) * (n + 1), "ssd_scan": steps[0] * n}
    else:
        want = {"chunk_attention": steps[0] * n, "decode_attention": steps[1] * n,
                "rmsnorm": (steps[0] + steps[1]) * (2 * n + 1),
                "moe_gmm": (steps[0] + steps[1]) * n * GMM_PER_LAYER if cfg.num_experts else 0,
                "quant_matmul": (steps[0] + steps[1]) * _qmm_per_step(n) if quantized else 0}
    if launches != {op: k for op, k in want.items() if k}:
        fail("serve", f"{label}: serve run launched {launches}, its steps need {want}")
    run = {"server": server, "reqs": reqs, "launches": launches,
           "kernel_launches": kernel_launches, "step_kernels": step_kernels, "stats": stats,
           "tokens": [list(r.tokens) for r in reqs], "steps": steps, "peak": peak,
           "median_ms": median_ms, "rows": (eng.chunk, eng.slots)}
    if cfg.family != "ssm":
        # every serve run here is bf16 with chunks of 128 rows: the library
        # is to take the tensor-core kernel for each chunk, the split decode
        # kernel for each decode tick
        split = {op: _flash_by_kernel(run, op, want) for op, want in
                 (("chunk_attention", "tensor_core"), ("decode_attention", "split_decode"))}
        print(f"[serve] {label}: flash launches by kernel, as the library reported them: "
              f"{split}")
    if cfg.num_experts:
        run["moe_gmm_by_kernel"] = _gmm_by_kernel(run)
        print(f"[serve] {label}: moe_gmm launches by kernel, as the library reported them: "
              f"{run['moe_gmm_by_kernel']}")
    return run


def phase_serve(torch) -> dict:
    """Run A, the contiguous serve, then the whole-prompt prefill on the
    same weights; returns run A's result and the prefill's launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import _build
    from repro_torch.launch.bundle import make_bundle
    from repro_torch.models.model import Model

    cfg = get_config(ARCH)
    runtime = Runtime()
    container = runtime.deploy(make_bundle(ARCH), device="cuda")
    for r in container.binding.reports:
        print(f"[serve] bind {r.op:<18} swapped={r.swapped} provider={r.bound} ({r.reason})")
        if not (r.swapped and r.bound == "cuda"):
            fail("serve", f"op {r.op} is not bound to its CUDA kernel: {r.reason}")
    run = _drive(torch, np, cfg, container, "A contiguous")
    eng = run.pop("server").engine
    # the whole-prompt entry point on the same deployment, counted on its
    # own: Model.prefill of request 0's prompt
    first = run["reqs"][0]
    _build.clear_launches()
    whole = eng.model.prefill({"tokens": first.prompt[None]})[0][0]
    torch.cuda.synchronize()
    whole_launches = dict(_build.LAUNCHES)
    whole_kernels = dict(_build.KERNEL_LAUNCHES)
    # request 0's chunked prefill replayed into slot 0, to hold the whole
    # prefill against (its launches are not counted)
    for start in range(0, first.prompt_len, eng.chunk):
        chunked = eng.prefill_step(0, first.prompt[start:start + eng.chunk], start)
    torch.cuda.synchronize()
    whole_np = whole.cpu().numpy()
    agree = int(np.argmax(whole_np)) == int(np.argmax(chunked))
    rel = float(np.abs(whole_np - chunked).max() / np.abs(chunked).max())
    print(f"[serve] Model.prefill of request 0 ({first.prompt_len} tokens): logits "
          f"{whole_np.shape} finite={bool(np.isfinite(whole_np).all())}; against its chunked "
          f"prefill: max rel diff {rel:.3g}, argmax agrees {agree} (bf16, informational)")
    print(f"[serve] launches in the whole-prompt Model.prefill: {whole_launches}")
    # the same whole prefill through the plain binding (weights shared): how
    # far bf16 rounding alone moves a 48-layer forward with these weights
    runtime.cleanup()
    plain = runtime.deploy(make_bundle(ARCH), device="cuda", native_ops=False)
    m_plain = Model(cfg, plain.binding, device="cuda").load_params(
        dict(eng.model.named_parameters()))
    whole_plain = m_plain.prefill({"tokens": first.prompt[None]})[0][0].cpu().numpy()
    rel_kp = float(np.abs(whole_np - whole_plain).max() / np.abs(whole_plain).max())
    rel_pc = float(np.abs(whole_plain - chunked).max() / np.abs(chunked).max())
    print(f"[serve] Model.prefill of request 0, CUDA binding against plain binding: max rel "
          f"diff {rel_kp:.3g}; plain whole prefill against the chunked prefill: {rel_pc:.3g} "
          f"(bf16, informational)")
    if not np.isfinite(whole_np).all() or whole_np.shape != (cfg.vocab_size,):
        fail("serve", "Model.prefill logits not finite or misshapen")
    if int(np.argmax(chunked)) != first.tokens[0]:
        fail("serve", "replayed chunked prefill does not reproduce request 0's first token")
    n = cfg.num_layers
    if whole_launches != {"attention": n, "rmsnorm": 2 * n + 1}:
        fail("serve", f"whole-prompt prefill launched {whole_launches}")
    # the one serve-level number the flash kernel's prefill launches move
    tokens = {"tokens": first.prompt[None]}
    ms = {name: _median_ms(torch, lambda m=m: m.prefill(tokens))
          for name, m in (("CUDA", eng.model), ("plain", m_plain))}
    print(f"[serve] Model.prefill of request 0 ({first.prompt_len} tokens), host clock, "
          f"synchronized, median of 3: CUDA binding {ms['CUDA']:.1f} ms, plain binding "
          f"{ms['plain']:.1f} ms")
    runtime.cleanup()
    whole = {"launches": whole_launches, "kernel_launches": whole_kernels}
    print(f"[serve] Model.prefill of request 0: attention launches by kernel, as the library "
          f"reported them: {_flash_by_kernel(whole, 'attention', 'tensor_core')}")
    return {"A": run, "whole": whole, "prefill_ms": ms}


def phase_serve_modes(torch, contiguous: dict) -> dict:
    """Runs E (contiguous, window 512), B (paged, 25 pages: 24 usable
    against the 64 a full layout needs, so admission waits on the pool)
    and D (paged, window 512, 21 pages: the lease cap is 5 pages a
    request), each on fresh seeded weights equal to run A's.  B's tokens
    must equal A's and D's E's: only addresses differ between them.  Then
    the windowed_attention op once through the deployed binding."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import _build
    from repro_torch.launch.bundle import make_bundle

    cfg = get_config(ARCH)
    runtime = Runtime()
    container = runtime.deploy(make_bundle(ARCH), device="cuda")
    for r in container.binding.reports:
        if not (r.swapped and r.bound == "cuda"):
            fail("serve", f"op {r.op} is not bound to its CUDA kernel: {r.reason}")
    runs = {}
    for key, label, kw in (("E", "E contiguous, window 512", {"window": WINDOW}),
                           ("B", "B paged, 25 pages", {"paged": True, "num_pages": 25}),
                           ("D", "D paged, window 512, 21 pages",
                            {"paged": True, "num_pages": 21, "window": WINDOW})):
        runs[key] = _drive(torch, np, cfg, container, label, **kw)
        runs[key].pop("server")
        gc.collect()
        torch.cuda.empty_cache()
    peak_b = runs["B"]["stats"]["pages-allocated-peak"]
    print(f"[serve] B: pages-allocated-peak {int(peak_b)} (limit 24); tokens equal to A's: "
          f"{runs['B']['tokens'] == contiguous['tokens']}")
    print(f"[serve] D: pages-allocated-peak {int(runs['D']['stats']['pages-allocated-peak'])} "
          f"(limit 20); tokens equal to E's: {runs['D']['tokens'] == runs['E']['tokens']}")
    if peak_b > 24:
        fail("serve", f"B allocated {peak_b} pages of 24")
    if runs["B"]["tokens"] != contiguous["tokens"]:
        fail("serve", "B (paged) tokens differ from A's (contiguous)")
    if runs["D"]["tokens"] != runs["E"]["tokens"]:
        fail("serve", "D (paged, windowed) tokens differ from E's (contiguous, windowed)")

    # windowed_attention, which no serve step calls: once through the
    # deployed binding at the kernel phase's bf16 shape
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for shape in ((1, MAX_LEN, h, dh), (1, MAX_LEN, kv, dh), (1, MAX_LEN, kv, dh)))
    _build.clear_launches()
    out = container.binding["windowed_attention"](q, k, v, WINDOW)
    torch.cuda.synchronize()
    wrun = {"launches": dict(_build.LAUNCHES), "kernel_launches": dict(_build.KERNEL_LAUNCHES)}
    print(f"[serve] binding['windowed_attention'] S={MAX_LEN} W={WINDOW}: launches "
          f"{wrun['launches']}, by kernel "
          f"{_flash_by_kernel(wrun, 'windowed_attention', 'tensor_core')}")
    if wrun["launches"] != {"windowed_attention": 1} or not torch.isfinite(out.float()).all():
        fail("serve", f"windowed_attention through the binding launched {wrun['launches']}")
    runtime.cleanup()
    return {**runs, "windowed_attention": wrun}


# --------------------------------------------------------------------------- #
# the quantized-weight path: qwen2.5-14b with int8 / fp8 weights
# --------------------------------------------------------------------------- #
def phase_kernels_quant(torch, flush) -> dict:
    """quant_matmul against quant_matmul_ref at qwen's MLP and LM-head
    shapes (decode T = 4, a 128-token chunk, the LM head of one token, a
    1316-token whole prompt, the model phase's 600-row prefill, and 129 and
    256 rows across the tensor-core tile's row and column edges), the
    quantization grid's ragged shapes (also inside QMM_ENVELOPE of the fp32
    product) and three shapes with a split contraction, after the
    kernels' occupancy as the wrapper reads it; x fp32 and bf16, int8 and
    fp8 codes, every launch pair torch.equal; then the byte table.  Times
    at the serving shapes; the library yardstick is torch.matmul on the
    dense weight in x's dtype (what the codes replace, not the same
    function).  Returns the main-path cases (bf16, int8, 5120 x 13824): T =
    4 (a decode tick) and T = 128 (a prefill chunk)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant import quantize_per_channel
    from repro_torch.kernels.quant_matmul import occupancy, plan, quant_matmul
    from repro_torch.kernels.quant_matmul_ref import quant_matmul_ref

    cfg = get_config(ARCH)
    d, f, v = cfg.d_model, cfg.d_ff, -(-cfg.vocab_size // 128) * 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    report = {}
    # (label, T, D, F, timed)
    cases = [("decode w_in", 4, d, f, True), ("decode w_out", 4, f, d, True),
             ("decode LM head", 4, d, v, True), ("chunk w_in", 128, d, f, True),
             ("chunk w_out", 128, f, d, True), ("chunk LM head", 1, d, v, True),
             ("whole prompt w_in", 1316, d, f, True), ("whole prompt w_out", 1316, f, d, True),
             # the model phase's prefill B=2 S=300: 18 full row tiles and one of 24 rows
             ("model prefill w_in", 600, d, f, False), ("model prefill w_out", 600, f, d, False),
             # the tensor-core tile's edges: one live row in the second row tile; a
             # 16-column second column tile over a contraction ending 40 rows into a step
             ("row edge", 129, d, f, False), ("column edge", 256, 1000, 144, False)]
    cases += [("grid", t, dd, ff, False) for t, dd, ff in QMM_GRID]
    cases += [("split", t, dd, ff, False) for t, dd, ff in QMM_SPLIT]
    for t in (4, 128, 600, 1316):
        for dtype, code in ((0, 0), (1, 0), (0, 1), (1, 1)):
            rows, resident, sms = occupancy(torch.cuda.current_device(), dtype, code, t)
            print(f"[kernels] quant_matmul T = {t}, dtype code {dtype}, code format {code}: "
                  f"{rows}-row tiles, {resident} blocks resident an SM, {sms} SMs")
    for label, t, din, dout, timed in cases:
        # the scaled init's spread, but N(0, 1) at the grid's shapes, as the
        # grid that set the envelope draws them
        w = torch.randn((din, dout), generator=gen, device="cuda")
        if label != "grid":
            w /= din ** 0.5
        for fmt in ("int8", "fp8"):
            qw, scale = quantize_per_channel(w, axis=-2, fmt=fmt)
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).removeprefix("torch.")
                es = torch.empty((), dtype=dtype).element_size()
                x = torch.randn((t, din), generator=gen, device="cuda").to(dtype)
                full = f"{label} [{t}, {din}] x [{din}, {dout}] {fmt}"
                got = quant_matmul(x, qw, scale)
                err = _check("kernels", f"quant_matmul {full}", got, quant_matmul_ref(x, qw, scale),
                             dn)
                again = quant_matmul(x, qw, scale)
                torch.cuda.synchronize()
                if not torch.isfinite(got.float()).all() or not torch.equal(got, again):
                    fail("kernels", f"quant_matmul {full} {dn}: non-finite, or two launches differ")
                if label == "grid":
                    dense = x.float() @ w
                    env = (got.float() - dense).abs().max().item()
                    print(f"[kernels] quant_matmul {full} {dn}: {env:.4f} from the fp32 product "
                          f"(envelope {QMM_ENVELOPE[fmt]})")
                    if env > QMM_ENVELOPE[fmt]:
                        fail("kernels", f"quant_matmul {full} {dn}: outside QMM_ENVELOPE")
                if not timed:
                    print(f"[kernels] quant_matmul {full:<48} {dn:<8} max_abs_err {err:.3g} "
                          f"splits {plan(x, qw)}, two launches equal")
                    continue
                dense_w = (qw.float() * scale).to(dtype)
                nbytes = t * din * es + din * dout + dout * 4 + t * dout * es
                key = "quant_matmul/chunk_w_in" if label == "chunk w_in" else "quant_matmul"
                _record(report, key, full + f" splits {plan(x, qw)[0]}", dn,
                        err, time_ms(torch, lambda: quant_matmul(x, qw, scale), flush),
                        time_ms(torch, lambda: quant_matmul_ref(x, qw, scale), flush),
                        time_ms(torch, lambda: torch.matmul(x, dense_w), flush),
                        bound_ms(nbytes, 2 * t * din * dout,
                                 PEAK_BF16_TC if dn == "bfloat16" else PEAK_FP32),
                        dn == "bfloat16" and fmt == "int8"
                        and label in ("decode w_in", "chunk w_in"))
                del dense_w
            del qw, scale
        print(f"[kernels] quant_matmul {label} [{din}, {dout}]: every case inside TOLS, "
              "bit-identical over two launches")
        del w
    _qmm_byte_table(torch)
    return report


def _qmm_byte_table(torch) -> None:
    """Every code decodes exactly: x the identity (256 rows, so bf16 takes
    the tensor-core kernel) against a (256, 16) code table holding each
    byte pattern in every column (e4m3's two NaN patterns, which the
    quantizer never writes, replaced by 0); each output is one code times
    its column's scale, so the kernel must equal quant_matmul_ref bit for
    bit."""
    from repro_torch.kernels.quant import STORAGE_DTYPES
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.kernels.quant_matmul_ref import quant_matmul_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    rows = torch.arange(256, device="cuda")[:, None]
    table = ((rows + 7 * torch.arange(16, device="cuda")[None, :]) % 256).to(torch.uint8)
    scale = torch.rand(16, generator=gen, device="cuda") + 0.5
    for fmt, qdt in STORAGE_DTYPES.items():
        codes = table.clone()
        if fmt == "fp8":
            codes[(codes == 0x7F) | (codes == 0xFF)] = 0
        codes = codes.view(qdt)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.eye(256, device="cuda", dtype=dtype)
            got = quant_matmul(x, codes, scale)
            if not torch.equal(got, quant_matmul_ref(x, codes, scale)):
                fail("kernels", f"quant_matmul byte table {fmt} {dtype}: a code decodes inexactly")
    print("[kernels] quant_matmul byte table: every int8 code and every finite e4m3 code "
          "decodes exactly, fp32 and bf16 x")


# --------------------------------------------------------------------------- #
# the quantized KV cache: serving over int8 / e4m3 caches
# --------------------------------------------------------------------------- #
def _quantized_tree(torch, cfg, fmt: str) -> dict:
    """The seeded weights of `cfg` (the draws `Model.init` makes with the
    serve phase's seed, so run A's weights for qwen) drawn on the card one
    leaf at a time and quantized there by the port's `quantize_tree`
    (`Model.draw`), each leaf's full-precision draw freed once it is
    quantized: the peak is the codes plus one leaf, not the full-precision
    tree plus the codes."""
    from repro_torch.models.model import Model

    return Model(cfg, {}, device="cuda").draw(torch.Generator(device="cuda").manual_seed(SEED),
                                              fmt)


def _departure(torch, label: str, m_cuda, m_plain, tokens) -> None:
    """Where the CUDA binding's whole-prompt prefill departs from the plain
    binding's; printed, not checked.  After the embedding and each block:
    the residual streams' largest difference over max |plain|, with its
    place (row, token, column), and the same at the last tokens, the only
    ones the logits read; the block's own part (the CUDA block on the plain
    stream); the attention's reach (the plain attention on the CUDA and on
    the plain pre-norm output: how far the norm's rounding moves it); and
    at the worst token, its largest pre-softmax score and the least gap
    between a head's two best keys.  Then the largest logit difference."""
    import numpy as np

    from repro_torch.models import layers as L

    cfg, pb, cb = m_plain.cfg, m_plain.binding, m_cuda.binding
    tag = f"[quant-model] {label} departure"
    with torch.no_grad():
        xc, xp = m_cuda._embed(tokens), m_plain._embed(tokens)
        positions = torch.arange(xp.shape[1], device=xp.device)
        print(f"{tag}: embedding {_rel(xc, xp):.3g}")
        for i in range(cfg.num_layers):
            blk = m_plain.layers[i]
            h_p = L.norm_apply(blk.pre_norm, xp, cfg, pb)
            h_c = L.norm_apply(blk.pre_norm, xp, cfg, cb)
            reach = _rel(L.attention_apply(blk.attn, h_c, cfg, pb, positions=positions)[0],
                         L.attention_apply(blk.attn, h_p, cfg, pb, positions=positions)[0])
            own = _rel(m_cuda._block(i, xp, "prefill", positions=positions)[0],
                       m_plain._block(i, xp, "prefill", positions=positions)[0])
            xc = m_cuda._block(i, xc, "prefill", positions=positions)[0]
            xp_next = m_plain._block(i, xp, "prefill", positions=positions)[0]
            diff = (xc - xp_next).abs()
            b, t, col = (int(v) for v in np.unravel_index(int(diff.argmax()), tuple(diff.shape)))
            q, k, _ = L._qkv(blk.attn, h_p, cfg, positions)
            group = cfg.num_heads // cfg.num_kv_heads
            keys = k[b, :t + 1].repeat_interleave(group, dim=1)          # (t+1, H, Dh)
            scores = torch.einsum("hd,jhd->hj", q[b, t], keys) / cfg.head_dim ** 0.5
            top2 = scores.topk(min(2, t + 1), dim=-1).values
            gap = (top2[:, 0] - top2[:, -1]).min().item()
            print(f"{tag}: block {i}: stream {_rel(xc, xp_next):.3g} at (row {b}, token {t}, "
                  f"column {col}), last tokens {_rel(xc[:, -1], xp_next[:, -1]):.3g}; the "
                  f"block's own {own:.3g}; pre-norm {_rel(h_c, h_p):.3g} moves the attention "
                  f"{reach:.3g}; token {t}: largest score {scores.max().item():.4g}, least "
                  f"top-two gap {gap:.3g}")
            xp = xp_next
        lc = m_cuda._logits(xc[:, -1:].contiguous())[:, 0]
        lp = m_plain._logits(xp[:, -1:].contiguous())[:, 0]
        d = (lc - lp).abs()
        b, col = (int(v) for v in np.unravel_index(int(d.argmax()), tuple(d.shape)))
        print(f"{tag}: logits {_rel(lc, lp):.3g} at (row {b}, column {col}): plain "
              f"{lp[b, col].item():.6g}, cuda {lc[b, col].item():.6g}; max |plain| by row "
              f"{[round(v, 4) for v in lp.abs().amax(-1).tolist()]}; the CUDA final norm and "
              f"LM head on the plain stream "
              f"{_rel(m_cuda._logits(xp[:, -1:].contiguous())[:, 0], lp):.3g}")


def phase_model_quant(torch) -> None:
    """qwen2.5-14b at full width, 2 layers, fp32, weights in storage form
    (int8, then fp8): the CUDA binding's logits against the plain binding's
    for prefill, prefill_into with a partial last chunk and decode with a
    parked slot, and the whole-prompt prefill against the chunked one; then
    prefill_into and decode again over a KV cache of the weights' format
    (the flash kernel's quantized-KV form)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax

    cfg = dataclasses.replace(get_config(ARCH), num_layers=2, dtype="float32")
    compare = _logit_check(torch, "quant-model", MODEL_RTOL)
    for fmt in ("int8", "fp8"):
        state = params_from_jax(_quantized_tree(torch, cfg, fmt), cfg)
        m_cuda, m_plain = _model_pair(torch, ARCH, cfg, init=False)
        m_cuda.load_params(state)
        m_plain.load_params(state)
        rng = np.random.default_rng(SEED)
        tokens = rng.integers(0, cfg.vocab_size, (2, 300))
        compare(f"{fmt} prefill B=2 S=300", m_cuda.prefill({"tokens": tokens})[0],
                m_plain.prefill({"tokens": tokens})[0])
        _departure(torch, f"{fmt} prefill B=2 S=300", m_cuda, m_plain, tokens)
        slots, max_len, chunk, slot = 3, 512, 128, 1
        prompt = rng.integers(0, cfg.vocab_size, 300)
        caches = {m: m.init_cache(slots, max_len) for m in (m_cuda, m_plain)}
        _, _, out = _prefill_chunks(np, caches, prompt, slot, chunk)[-1]
        compare(f"{fmt} prefill_into slot {slot}, 300 = 128+128+44", out[m_cuda], out[m_plain])
        whole = m_cuda.prefill({"tokens": prompt[None]})[0]
        rel = _rel(whole, out[m_cuda])
        print(f"[quant-model] {fmt} cuda binding: whole-prompt prefill vs prefill_into, max rel "
              f"diff {rel:.3g} (limit {MODEL_RTOL})")
        if rel > MODEL_RTOL:
            fail("quant-model", f"{fmt}: chunked prefill disagrees with whole-prompt prefill")
        token = rng.integers(0, cfg.vocab_size, (slots, 1))
        pos = np.array([5, len(prompt), max_len - 1], np.int32)
        out = {m: m.decode(token, caches[m], pos)[0] for m in caches}
        compare(f"{fmt} decode pos [5, 300, 511 parked]", out[m_cuda], out[m_plain])
        k_cuda, k_plain = _model_pair(torch, ARCH, cfg, init=False, kv_quantize=fmt)
        k_cuda.load_params(state)
        k_plain.load_params(state)
        kcaches = {m: m.init_cache(slots, max_len) for m in (k_cuda, k_plain)}
        _, _, out = _prefill_chunks(np, kcaches, prompt, slot, chunk)[-1]
        compare(f"{fmt} KV: prefill_into slot {slot}, 300 = 128+128+44", out[k_cuda],
                out[k_plain])
        out = {m: m.decode(token, kcaches[m], pos)[0] for m in kcaches}
        compare(f"{fmt} KV: decode pos [5, 300, 511 parked]", out[k_cuda], out[k_plain])
        apart = sum(int((kcaches[k_cuda]["p0"][name].view(torch.uint8)
                         != kcaches[k_plain]["p0"][name].view(torch.uint8)).sum())
                    for name in ("k", "v"))
        print(f"[quant-model] {fmt} KV: {apart} of {2 * kcaches[k_cuda]['p0']['k'].numel()} "
              "codes differ between the CUDA and plain models' caches (informational)")
        del state, m_cuda, m_plain, caches, out, whole, k_cuda, k_plain, kcaches
        gc.collect()
        torch.cuda.empty_cache()


def _clip_share(torch, cache, fmt: str) -> tuple[float, float]:
    """The share of K and of V codes at the clip (+-127 / +-448) among the
    positions a run wrote: a position (a cache row or a pool page's row)
    counts as written when any of its codes is not zero (the cache starts
    at zero); one layer at a time in float32."""
    top = 127.0 if fmt == "int8" else 448.0
    shares = []
    for name in ("k", "v"):
        at = written = 0
        for layer in cache["p0"][name]:
            x = layer.float().abs()
            at += int((x == top).sum())
            written += int((x != 0).flatten(-2).any(-1).sum()) * x.shape[-2] * x.shape[-1]
        shares.append(at / max(written, 1))
    return shares[0], shares[1]


def _drive_kv(torch, np, cfg, container, label, fmt, tree, **engine_kw) -> dict:
    """A run with `quantize=fmt` (weights in storage form, KV cache of the
    same format) on `tree`: the cache must hold 1-byte codes; prints the
    share of codes at the clip, then the attention launches a step and the
    peak memory."""
    from repro_torch.models.model import KV_CALIBRATION_AMAX

    run = _drive(torch, np, cfg, container, label, params=tree, quantize=fmt, **engine_kw)
    eng = run.pop("server").engine
    k = eng.cache["p0"]["k"]
    if k.dtype != {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[fmt] or k.element_size() != 1:
        fail("quant-serve", f"{label}: a KV cache of {k.dtype}, not 1-byte {fmt} codes")
    ks, vs = _clip_share(torch, eng.cache, fmt)
    print(f"[quant-serve] {label}: K codes at the clip {ks:.6g}, V codes {vs:.6g} of the "
          f"written positions' codes (every slot's scale {eng.model.kv_scale_init:.6g}: the "
          f"calibration amax {KV_CALIBRATION_AMAX} over the format's top; informational)")
    (pre, dec), launches = run["steps"], run["launches"]
    print(f"[quant-serve] {label}: {k.dtype} KV cache of {k.numel() * 2} bytes (k and v); "
          f"chunk_attention {launches['chunk_attention'] / pre:g} a prefill step, "
          f"decode_attention {launches['decode_attention'] / dec:g} a decode step; peak "
          f"memory {run['peak']} bytes")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return run


def phase_serve_quant(torch, contiguous: dict) -> dict:
    """Full qwen2.5-14b (48 layers, bf16) with its matmul weights in storage
    form, drawn from run A's seed and quantized on the card: run Q8 (int8,
    contiguous) with one whole-prompt Model.prefill, run Q8P (int8, paged
    on 25 pages; its tokens must equal Q8's), then on the same int8 tree
    served with quantize="int8", so that the KV cache is int8 too, run K8
    (contiguous) and K8P (paged on 25 pages; its tokens must equal K8's);
    on the fp8 tree run QF8 (contiguous) and KF8 (quantize="fp8",
    contiguous).  Every step launches quant_matmul exactly 3 x 48 + 1
    times."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import _build
    from repro_torch.launch.bundle import make_bundle

    cfg = get_config(ARCH)
    n = cfg.num_layers
    print(f"[quant-serve] device memory allocated before the quantized runs: "
          f"{torch.cuda.memory_allocated()} bytes")
    runtime = Runtime()
    container = runtime.deploy(make_bundle(ARCH), device="cuda")
    for r in container.binding.reports:
        if not (r.swapped and r.bound == "cuda"):
            fail("quant-serve", f"op {r.op} is not bound to its CUDA kernel: {r.reason}")
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = _quantized_tree(torch, cfg, "int8")
    torch.cuda.synchronize()
    print(f"[quant-serve] int8 tree drawn and quantized on the card in "
          f"{time.perf_counter() - t0:.1f} s, peak memory {torch.cuda.max_memory_allocated()} bytes")
    q8 = _drive(torch, np, cfg, container, "Q8 int8, contiguous", params=tree)
    eng = q8.pop("server").engine
    first = q8["reqs"][0]
    _build.clear_launches()
    whole = eng.model.prefill({"tokens": first.prompt[None]})[0][0]
    torch.cuda.synchronize()
    whole_launches = dict(_build.LAUNCHES)
    whole_np = whole.cpu().numpy()
    print(f"[quant-serve] Model.prefill of request 0 ({first.prompt_len} tokens): logits "
          f"{whole_np.shape} finite={bool(np.isfinite(whole_np).all())}; argmax equals run Q8's "
          f"first token {int(np.argmax(whole_np)) == first.tokens[0]} (bf16, informational); "
          f"launches {whole_launches}")
    if not np.isfinite(whole_np).all() or whole_np.shape != (cfg.vocab_size,):
        fail("quant-serve", "Model.prefill logits not finite or misshapen")
    if whole_launches != {"attention": n, "rmsnorm": 2 * n + 1,
                          "quant_matmul": _qmm_per_step(n)}:
        fail("quant-serve", f"whole-prompt prefill launched {whole_launches}")
    runs["prefill"] = whole_launches
    del eng, whole
    gc.collect()
    torch.cuda.empty_cache()
    q8p = _drive(torch, np, cfg, container, "Q8P int8, paged, 25 pages", params=tree,
                 paged=True, num_pages=25)
    q8p.pop("server")
    gc.collect()
    torch.cuda.empty_cache()
    first_a = sum(a[0] == b[0] for a, b in zip(q8["tokens"], contiguous["tokens"]))
    print(f"[quant-serve] Q8P: pages-allocated-peak {int(q8p['stats']['pages-allocated-peak'])} "
          f"(limit 24); tokens equal to Q8's: {q8p['tokens'] == q8['tokens']}; Q8's first "
          f"tokens equal to run A's (the same weights in bf16): {first_a} of 8 (informational)")
    if q8p["stats"]["pages-allocated-peak"] > 24:
        fail("quant-serve", "Q8P allocated more than its 24 pages")
    if q8p["tokens"] != q8["tokens"]:
        fail("quant-serve", "Q8P (paged) tokens differ from Q8's (contiguous)")
    k8 = _drive_kv(torch, np, cfg, container, "K8 int8 weights and KV cache, contiguous", "int8",
                   tree)
    k8p = _drive_kv(torch, np, cfg, container, "K8P int8 weights and KV cache, paged, 25 pages",
                    "int8", tree, paged=True, num_pages=25)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    same = sum(a == b for ka, qa in zip(k8["tokens"], q8["tokens"]) for a, b in zip(ka, qa))
    first = sum(a[0] == b[0] for a, b in zip(k8["tokens"], q8["tokens"]))
    print(f"[quant-serve] K8P: pages-allocated-peak "
          f"{int(k8p['stats']['pages-allocated-peak'])} (limit 24); tokens equal to K8's: "
          f"{k8p['tokens'] == k8['tokens']}; K8 against Q8 (the same weights over a bf16 "
          f"cache): first tokens equal {first} of 8, tokens equal at the same place {same} of "
          f"{sum(map(len, q8['tokens']))} (informational)")
    if k8p["stats"]["pages-allocated-peak"] > 24:
        fail("quant-serve", "K8P allocated more than its 24 pages")
    if k8p["tokens"] != k8["tokens"]:
        fail("quant-serve", "K8P (paged) tokens differ from K8's (contiguous)")
    tree = _quantized_tree(torch, cfg, "fp8")
    qf8 = _drive(torch, np, cfg, container, "QF8 fp8, contiguous", params=tree)
    qf8.pop("server")
    kf8 = _drive_kv(torch, np, cfg, container, "KF8 fp8 weights and KV cache, contiguous", "fp8",
                    tree)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(Q8=q8, Q8P=q8p, QF8=qf8, K8=k8, K8P=k8p, KF8=kf8)
    runs["Q8 by kernel"] = _qmm_by_kernel(q8, n)
    print(f"[quant-serve] Q8: quant_matmul launches by kernel {runs['Q8 by kernel']}")
    a_pre, a_dec = contiguous["median_ms"]["prefill"], contiguous["median_ms"]["decode"]
    for name in ("Q8", "Q8P", "QF8", "K8", "K8P", "KF8"):
        pre, dec = runs[name]["median_ms"]["prefill"], runs[name]["median_ms"]["decode"]
        print(f"[quant-serve] {name}: median prefill step {pre:.1f} ms, {pre / a_pre:.2f}x run "
              f"A's {a_pre:.1f}; median decode step {dec:.1f} ms, {dec / a_dec:.2f}x A's "
              f"{a_dec:.1f} (host clock; informational)")
    runtime.cleanup()
    return runs


# --------------------------------------------------------------------------- #
# the MoE path: moonshot-v1-16b-a3b
# --------------------------------------------------------------------------- #
def _routed_sizes(torch, gen, tokens, e, k):
    """Group sizes (E,) int32 on the card of `tokens` tokens each routed to
    k distinct experts drawn at random: what top-k routing gives."""
    pick = torch.rand((tokens, e), generator=gen, device="cuda").argsort(dim=1)[:, :k]
    return torch.bincount(pick.reshape(-1), minlength=e).to(torch.int32)


def _library_gmm(torch, x, w, gs, want, dn):
    """One PyTorch call computing the grouped matmul, where the card's torch
    has one (torch._grouped_mm, bf16): a callable, held against `want`
    first, or None."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None or dn != "bfloat16":
        return None
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    try:
        got = fn(x, w, offs=offs)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError):
        return None
    tol = TOLS[dn]
    if got.shape != want.shape or not torch.allclose(got.float(), want.float(), atol=tol,
                                                     rtol=tol):
        return None
    return lambda: fn(x, w, offs=offs)


def phase_kernels_moe(torch, flush) -> dict:
    """moe_gmm against moe_gmm_exact at moonshot's expert shapes, and the
    flash kernel's chunk and decode forms at its H = KV = 16 geometry;
    returns the main-path cases (bf16) keyed for the kernels line."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.flash_attention_ref import chunk_attention_ref, decode_attention_ref
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.moe_gmm_ref import moe_gmm_exact

    def took(x, w, gs):
        """moe_gmm(x, w, gs) and the kernel the library reported for it."""
        before = dict(_build.KERNEL_LAUNCHES)
        out = moe_gmm(x, w, gs)
        new = [k for (op, k), n in _build.KERNEL_LAUNCHES.items()
               if op == "moe_gmm" and n != before.get((op, k), 0)]
        return out, new

    cfg = get_config(MOE_ARCH)
    d, e, f, k = cfg.d_model, cfg.num_experts, cfg.expert_d_ff, cfg.top_k
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    report = {}
    one = torch.zeros(e, dtype=torch.int32, device="cuda")
    one[17] = 768
    # (label, group sizes, the kernel a bf16 launch takes; fp32 always
    # takes "fma"): decode of 4 slots, a 128-token chunk, request 0's whole
    # 1316-token prompt (above the plain binding's 1024-row dropless limit:
    # the kernel stays dropless), every row in one expert
    cases = [("T=24 decode", _routed_sizes(torch, gen, 4, e, k), "fma"),
             ("T=768 chunk", _routed_sizes(torch, gen, 128, e, k), "tensor_core"),
             ("T=7896 whole prompt", _routed_sizes(torch, gen, 1316, e, k), "tensor_core"),
             ("T=768 one expert", one, "tensor_core")]
    # the timed cases, and the kernels-line key of each at w_in's shape
    timed = {"T=24 decode": "moe_gmm/decode", "T=768 chunk": "moe_gmm",
             "T=7896 whole prompt": "moe_gmm/whole_prompt", "T=768 one expert": None}
    # the tensor-core kernel's edges (bf16): T at the cut (E) and one below
    # it, groups across its 16-row slices and 128-row tiles, every row in
    # the last expert, and sizes summing short of T (tail rows zero); drawn
    # from a generator of their own, so the timed cases keep their inputs
    egen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    cut = [torch.bincount(torch.randint(0, e, (n,), generator=egen, device="cuda"),
                          minlength=e).to(torch.int32) for n in (e, e - 1)]
    groups = torch.zeros(e, dtype=torch.int32, device="cuda")
    groups[torch.tensor([3, 9, 10, 20, 40, 63])] = torch.tensor([1, 16, 17, 64, 65, 129],
                                                                dtype=torch.int32,
                                                                device="cuda")
    last = torch.zeros(e, dtype=torch.int32, device="cuda")
    last[e - 1] = 300
    short = torch.zeros(e, dtype=torch.int32, device="cuda")
    short[torch.tensor([0, 5, 6])] = torch.tensor([40, 100, 60], dtype=torch.int32,
                                                  device="cuda")
    short_label, short_t = "T=300, sizes summing to 200", 300
    edges = [(f"T={e} at the cut", cut[0], "tensor_core"),
             (f"T={e - 1} below the cut", cut[1], "fma"),
             ("groups of 1/16/17/64/65/129", groups, "tensor_core"),
             ("T=300 in the last expert", last, "tensor_core"),
             (short_label, short, "tensor_core")]
    # D and F ending inside a k stage and a column tile: D = 80 is one and
    # a quarter 64-wide stages, 136 ends half-way through a k16 step; F =
    # 136 fills 8 columns of a second 128-column tile, 24 three fragments
    # of the first.  Moonshot's widths are whole tiles and stages
    ragged = ((80, 136), (136, 24))
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        es = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_BF16_TC if dn == "bfloat16" else PEAK_FP32
        for din, dout in ((d, f), (f, d)) + (ragged if dn == "bfloat16" else ()):
            wide = (din, dout) not in ragged
            # the scaled init's spread, so fp32 sums over D stay inside TOLS
            w = (torch.randn((e, din, dout), generator=gen if wide else egen, device="cuda")
                 / din ** 0.5).to(dtype)
            for label, gs, name in (cases if wide else []) + (edges if dn == "bfloat16" else []):
                name = name if dn == "bfloat16" else "fma"
                used_rows = int(gs.sum())
                t = short_t if label == short_label else used_rows
                x = torch.randn((t, din), generator=gen if label in timed else egen,
                                device="cuda").to(dtype)
                full = f"{label} w [{e}, {din}, {dout}]"
                got, kernel = took(x, w, gs)
                want = moe_gmm_exact(x, w, gs)
                err = _check("kernels", f"moe_gmm {full}", got, want, dn)
                again = moe_gmm(x, w, gs)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail("kernels", f"moe_gmm {full} {dn}: two launches differ")
                if kernel != [name]:
                    fail("kernels", f"moe_gmm {full} {dn}: the library reported {kernel}, "
                                    f"not {name}")
                if not got[used_rows:].eq(0).all():
                    fail("kernels", f"moe_gmm {full} {dn}: rows past sum(group_sizes) not 0")
                if label not in timed or not wide:
                    print(f"[kernels] moe_gmm {full:<54} {dn:<8} max_abs_err {err:.3g} on "
                          f"{kernel[0]}, launch pair equal")
                    del x, got, again, want
                    continue
                lib = _library_gmm(torch, x, w, gs, want, dn)
                used = int((gs > 0).sum())
                nbytes = (t * din + t * dout) * es + used * din * dout * es + e * 4
                _record(report, timed[label] or "moe_gmm",
                        full + f" ({used} experts used, {kernel[0]})", dn, err,
                        time_ms(torch, lambda: moe_gmm(x, w, gs), flush),
                        time_ms(torch, lambda: moe_gmm_exact(x, w, gs), flush),
                        None if lib is None else time_ms(torch, lib, flush),
                        bound_ms(nbytes, 2 * t * din * dout, peak),
                        dn == "bfloat16" and din == d and timed[label] is not None)
                del x, got, again, want
            print(f"[kernels] moe_gmm {dn} w [{e}, {din}, {dout}]: every case within TOLS, "
                  "bit-identical over two launches, on the kernel each case names")
            del w

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        # chunk and decode attention at H = KV = 16 (one query head a KV head)
        c, cpos = 128, 1900
        kc, vc = randn(1, MAX_LEN, kv, dh), randn(1, MAX_LEN, kv, dh)
        q = randn(1, c, h, dh)
        lim = cpos + torch.arange(c, device="cuda")[:, None]
        mask = (torch.arange(MAX_LEN, device="cuda")[None, :] <= lim)[None, None]
        qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        err = _check("kernels", f"chunk_attention MHA-16 pos={cpos}",
                     ops._cuda_chunk_attention(q, kc, vc, cpos),
                     chunk_attention_ref(q, kc, vc, cpos), dn)
        _record(report, "chunk_attention/mha16", f"C={c} pos={cpos} H=KV={h}", dn, err,
                time_ms(torch, lambda: ops._cuda_chunk_attention(q, kc, vc, cpos), flush),
                time_ms(torch, lambda: chunk_attention_ref(q, kc, vc, cpos), flush),
                time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      attn_mask=mask), flush),
                attn_bound(1, c, h, kv, dh, cpos + c, c * cpos + c * (c + 1) // 2, es, dn),
                dn == "bfloat16")
        positions = (100, 700, 1600, MAX_LEN - 1)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        q, kc, vc = randn(4, 1, h, dh), randn(4, MAX_LEN, kv, dh), randn(4, MAX_LEN, kv, dh)
        mask = (torch.arange(MAX_LEN, device="cuda")[None, :] <= pos[:, None])[:, None, None]
        qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        err = _check("kernels", "decode_attention MHA-16 B=4",
                     ops._cuda_decode_attention(q, kc, vc, pos),
                     decode_attention_ref(q, kc, vc, pos), dn)
        keys = sum(p + 1 for p in positions)
        _record(report, "decode_attention/mha16", f"B=4 Smax={MAX_LEN} H=KV={h}", dn, err,
                time_ms(torch, lambda: ops._cuda_decode_attention(q, kc, vc, pos), flush),
                time_ms(torch, lambda: decode_attention_ref(q, kc, vc, pos), flush),
                time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      attn_mask=mask), flush),
                attn_bound(4, 1, h, kv, dh, keys, keys, es, dn), dn == "bfloat16")
        del q, kc, vc, qt, kt, vt
    return report


def phase_model_moe(torch) -> None:
    """Moonshot at full width, 2 layers, fp32: the CUDA binding's logits
    against the plain binding's for prefill_into (a 128-token chunk is 768
    rows) and decode, and its whole-prompt prefill against its chunked
    one; then one MoE layer under the sync debug mode."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_apply

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=2, dtype="float32")
    m_cuda, m_plain = _model_pair(torch, MOE_ARCH, cfg)
    rng = np.random.default_rng(SEED)
    compare = _logit_check(torch, "moe-model", MODEL_RTOL)

    slots, max_len, chunk, slot = 3, 512, 128, 1
    prompt = rng.integers(0, cfg.vocab_size, 300)
    caches = {m: m.init_cache(slots, max_len) for m in (m_cuda, m_plain)}
    _, _, out = _prefill_chunks(np, caches, prompt, slot, chunk)[-1]
    compare(f"prefill_into slot {slot}, 300 = 128+128+44", out[m_cuda], out[m_plain])
    # the whole prompt is 1800 moe_gmm rows a layer: dropless through the
    # kernel (not through the plain binding), so it must agree with the
    # chunked prefill
    whole = m_cuda.prefill({"tokens": prompt[None]})[0]
    rel = _rel(whole, out[m_cuda])
    print(f"[moe-model] cuda binding: whole-prompt prefill ({len(prompt) * cfg.top_k} rows a "
          f"layer) vs prefill_into, max rel diff {rel:.3g} (limit {MODEL_RTOL})")
    if rel > MODEL_RTOL:
        fail("moe-model", "whole-prompt prefill disagrees with chunked prefill")
    token = rng.integers(0, cfg.vocab_size, (slots, 1))
    pos = np.array([5, len(prompt), max_len - 1], np.int32)
    out = {m: m.decode(token, caches[m], pos)[0] for m in caches}
    compare("decode pos [5, 300, 511 parked]", out[m_cuda], out[m_plain])

    # the card path of one MoE layer reads nothing back to the host: no
    # .item()/.tolist()/.cpu() of the routing or the group sizes
    x = torch.randn((1, chunk, cfg.d_model), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe_apply(m_cuda.layers[0].moe, x, cfg, m_cuda.binding)
    except RuntimeError as exc:
        fail("moe-model", f"moe_apply synchronised with the host on the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[moe-model] moe_apply of a {chunk}-token chunk under set_sync_debug_mode('error'): "
          f"no host synchronisation, output {tuple(y.shape)} finite "
          f"{bool(torch.isfinite(y).all())}")


def phase_serve_moe(torch) -> dict:
    """Run M (contiguous), the whole-prompt prefill of request 0, and run
    MP (paged, 25 pages) on full moonshot; MP's tokens must equal M's."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import _build
    from repro_torch.launch.bundle import make_bundle
    from repro_torch.models.model import Model

    cfg = get_config(MOE_ARCH)
    print(f"[moe-serve] device memory allocated before the MoE runs: "
          f"{torch.cuda.memory_allocated()} bytes")
    runtime = Runtime()
    container = runtime.deploy(make_bundle(MOE_ARCH), device="cuda")
    for r in container.binding.reports:
        print(f"[moe-serve] bind {r.op:<18} swapped={r.swapped} provider={r.bound} ({r.reason})")
        if not (r.swapped and r.bound == "cuda"):
            fail("moe-serve", f"op {r.op} is not bound to its CUDA kernel: {r.reason}")
    runs = {}
    m = _drive(torch, np, cfg, container, "M contiguous")
    eng = m.pop("server").engine
    first = m["reqs"][0]
    _build.clear_launches()
    whole = eng.model.prefill({"tokens": first.prompt[None]})[0][0]
    torch.cuda.synchronize()
    whole_launches = dict(_build.LAUNCHES)
    whole_kernels = {k: n for (op, k), n in _build.KERNEL_LAUNCHES.items() if op == "moe_gmm"}
    whole_np = whole.cpu().numpy()
    agree = int(np.argmax(whole_np)) == first.tokens[0]
    print(f"[moe-serve] Model.prefill of request 0 ({first.prompt_len} tokens, "
          f"{first.prompt_len * cfg.top_k} moe_gmm rows a layer): logits {whole_np.shape} "
          f"finite={bool(np.isfinite(whole_np).all())}; argmax equals run M's first token "
          f"{agree} (bf16, informational); launches {whole_launches}")
    n = cfg.num_layers
    if not np.isfinite(whole_np).all() or whole_np.shape != (cfg.vocab_size,):
        fail("moe-serve", "Model.prefill logits not finite or misshapen")
    if whole_launches != {"attention": n, "rmsnorm": 2 * n + 1, "moe_gmm": GMM_PER_LAYER * n}:
        fail("moe-serve", f"whole-prompt prefill launched {whole_launches}")
    print(f"[moe-serve] Model.prefill of request 0: moe_gmm launches by kernel, as the library "
          f"reported them: {whole_kernels}")
    if whole_kernels != {"tensor_core": GMM_PER_LAYER * n}:
        fail("moe-serve", f"whole-prompt moe_gmm launches {whole_kernels}: not all "
                          f"{GMM_PER_LAYER * n} on the tensor-core kernel")
    # the serve-level number moe_gmm's whole-prompt launches move, beside
    # the same prefill through the plain binding (weights shared; above
    # 1024 rows its moe_gmm is the capacity formulation, so only a scale)
    runtime.cleanup()
    plain = runtime.deploy(make_bundle(MOE_ARCH), device="cuda", native_ops=False)
    m_plain = Model(cfg, plain.binding, device="cuda").load_params(
        dict(eng.model.named_parameters()))
    tokens = {"tokens": first.prompt[None]}
    ms = {name: _median_ms(torch, lambda mdl=mdl: mdl.prefill(tokens))
          for name, mdl in (("CUDA", eng.model), ("plain", m_plain))}
    print(f"[moe-serve] Model.prefill of request 0 ({first.prompt_len} tokens), host clock, "
          f"synchronized, median of 3: CUDA binding {ms['CUDA']:.1f} ms, plain binding "
          f"{ms['plain']:.1f} ms")
    del m_plain
    runtime.cleanup()
    container = runtime.deploy(make_bundle(MOE_ARCH), device="cuda")
    runs["M"] = m
    runs["prefill"] = {"launches": whole_launches,
                       "by_kernel": {"fma": 0, "tensor_core": 0, **whole_kernels}}
    # run M's 57.8 GB of weights go before MP draws its own (the same seed,
    # so the same weights)
    del eng, whole
    gc.collect()
    torch.cuda.empty_cache()
    mp = _drive(torch, np, cfg, container, "MP paged, 25 pages", paged=True, num_pages=25)
    mp.pop("server")
    gc.collect()
    torch.cuda.empty_cache()
    runs["MP"] = mp
    peak = mp["stats"]["pages-allocated-peak"]
    print(f"[moe-serve] MP: pages-allocated-peak {int(peak)} (limit 24); tokens equal to M's: "
          f"{mp['tokens'] == m['tokens']}")
    if peak > 24:
        fail("moe-serve", f"MP allocated {peak} pages of 24")
    if mp["tokens"] != m["tokens"]:
        fail("moe-serve", "MP (paged) tokens differ from M's (contiguous)")
    runtime.cleanup()
    return runs


# --------------------------------------------------------------------------- #
# the SSM path: mamba2-780m on the ssd_scan kernel
# --------------------------------------------------------------------------- #
def _ssd_inputs(torch, gen, b, s, h, p, g, n, dtype, live=None, unit=False):
    """Seeded SSD inputs drawn as tests/test_kernels.py draws them: x
    N(0, 0.5^2), B and C N(0, 0.3^2) in `dtype`, dt = softplus(N(0, 1)) and
    A = -exp(N(0, 0.3^2)) in float32 (`unit`: x, B and C N(0, 1)); with
    `live`, dt is zero past row `live` (a prompt's padded last chunk)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    sx, sbc = (1.0, 1.0) if unit else (0.5, 0.3)
    x = (sx * randn(b, s, h, p)).to(dtype)
    bm, cm = ((sbc * randn(b, s, g, n)).to(dtype) for _ in range(2))
    dt = torch.nn.functional.softplus(randn(b, s, h))
    if live is not None:
        dt[:, live:] = 0
    a = -torch.exp(0.3 * randn(h))
    return x, dt, a, bm, cm


def _ssd_sequential64(torch, x, dt, a, bm, cm):
    """The recurrence itself, one position at a time in float64: the
    yardstick both fp32 evaluations (kernel and plain) are rounded from."""
    b, s, h, p = x.shape
    rep = h // bm.shape[2]
    xd, dtd, ad = x.double(), dt.double(), a.double()
    bd = bm.double().repeat_interleave(rep, dim=2)
    cd = cm.double().repeat_interleave(rep, dim=2)
    state = torch.zeros((b, h, bm.shape[3], p), dtype=torch.float64, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtd[:, t] * ad)[..., None, None]
        state = state * decay + dtd[:, t, :, None, None] * bd[:, t, :, :, None] * xd[:, t, :, None]
        ys.append(torch.einsum("bhn,bhnp->bhp", cd[:, t], state))
    return torch.stack(ys, dim=1), state


def ssd_bound(b, s, h, p, g, n, chunk, esize, dtype_name):
    """x and y, B, C and dt read or written once, the fp32 final state
    written once; the products the dual form needs: C B^T on the causal
    pairs once per group and chunk, M x on the causal pairs and the state
    update per head and chunk, and C . state per head for every chunk after
    the first (the state entering the first is zero)."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * esize + 4 * (b * s * h + h + b * h * n * p)
    macs = b * nc * (g * pairs * n + h * pairs * p + h * chunk * n * p)
    macs += b * (nc - 1) * h * chunk * n * p
    return bound_ms(nbytes, 2 * macs, PEAK_BF16_TC if dtype_name == "bfloat16" else PEAK_FP32)


def phase_kernels_ssd(torch, flush) -> dict:
    """ssd_scan against ssd_scan_ref at mamba2-780m's widths (H = 48, P =
    64, N = 128): the serve chunk (S = chunk = 128), the same with dt zero
    past row 37, the whole 1316-token prompt (chunk gcd(128, 1316) = 4),
    B = 2 S = 2048 (16 carried chunks) and G = 8 groups; fp32 and bf16,
    y and the final state within TOLS, each launch pair torch.equal.  Times
    (L2 flushed) at the main path's cases; no single PyTorch call computes
    the scan, so the library column is empty.  Returns the main-path cases
    (bf16: the serve chunk, the whole prompt)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan_ref import ssd_scan_ref

    cfg = get_config(SSM_ARCH)
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    report = {}
    # (key of a main-path case or None, label, B, S, G, chunk, live rows)
    cases = [("ssd_scan", "serve chunk", 1, 128, 1, 128, None),
             (None, "serve chunk, dt zero past row 37", 1, 128, 1, 128, 37),
             ("ssd_scan/whole_prompt", "whole prompt", 1, 1316, 1, 4, None),
             (None, "16 carried chunks", 2, 2048, 1, 128, None),
             (None, "8 groups", 1, 256, 8, 128, None)]
    for key, label, b, s, g, chunk, live in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).removeprefix("torch.")
            es = torch.empty((), dtype=dtype).element_size()
            args = _ssd_inputs(torch, gen, b, s, h, p, g, n, dtype, live)
            full = f"{label}: B={b} S={s} H={h} P={p} G={g} N={n} chunk {chunk}"
            y, st = ssd_scan(*args, chunk=chunk)
            y_ref, st_ref = ssd_scan_ref(*args, chunk=chunk)
            err = max(_check("kernels", f"ssd_scan {full} y", y, y_ref, dn),
                      _check("kernels", f"ssd_scan {full} state", st, st_ref, dn))
            y2, st2 = ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            if not (torch.isfinite(y.float()).all() and torch.isfinite(st).all()):
                fail("kernels", f"ssd_scan {full} {dn}: non-finite output")
            if not (torch.equal(y, y2) and torch.equal(st, st2)):
                fail("kernels", f"ssd_scan {full} {dn}: two launches differ")
            if key is None:
                print(f"[kernels] ssd_scan {full:<60} {dn:<8} max_abs_err {err:.3g}, "
                      "two launches equal")
                continue
            _record(report, key, full, dn, err,
                    time_ms(torch, lambda: ssd_scan(*args, chunk=chunk), flush),
                    time_ms(torch, lambda: ssd_scan_ref(*args, chunk=chunk), flush, iters=5),
                    None, ssd_bound(b, s, h, p, g, n, chunk, es, dn), dn == "bfloat16")
            del args, y, st, y_ref, st_ref, y2, st2
    # at unit scale (x, B, C ~ N(0, 1): scores C.B of spread sqrt(N) = 11)
    # fp32 rounding alone exceeds TOLS, so both evaluations are held against
    # the recurrence in float64: the kernel may be at most UNIT_SCALE_RATIO
    # times as far from it as the plain version, in y and in the state
    args = _ssd_inputs(torch, gen, 1, 128, h, p, 1, n, torch.float32, unit=True)
    y64, st64 = _ssd_sequential64(torch, *args)
    outs = {"kernel": ssd_scan(*args, chunk=128), "plain": ssd_scan_ref(*args, chunk=128)}
    errs = {name: ((y.double() - y64).abs().max().item(), (st.double() - st64).abs().max().item())
            for name, (y, st) in outs.items()}
    gap = (outs["kernel"][0] - outs["plain"][0]).abs().max().item()
    print(f"[kernels] ssd_scan unit-scale serve chunk, fp32, max |y| {y64.abs().max().item():.4g}: "
          f"kernel - plain {gap:.3g}; against the float64 recurrence "
          f"y / state: kernel {errs['kernel'][0]:.3g} / {errs['kernel'][1]:.3g}, plain "
          f"{errs['plain'][0]:.3g} / {errs['plain'][1]:.3g} (limit {UNIT_SCALE_RATIO}x plain)")
    for i, part in enumerate(("y", "state")):
        if not errs["kernel"][i] <= UNIT_SCALE_RATIO * errs["plain"][i]:
            fail("kernels", f"ssd_scan unit-scale {part}: {errs['kernel'][i]:.3g} from the "
                            f"float64 recurrence, more than {UNIT_SCALE_RATIO}x the plain "
                            f"version's {errs['plain'][i]:.3g}")
    print("[kernels] ssd_scan: every case inside TOLS, bit-identical over two launches")
    return report


def phase_model_ssm(torch) -> None:
    """mamba2 at full width, 2 layers, fp32: the CUDA binding's logits
    against the plain binding's for prefill (B = 2, S = 300: chunk
    gcd(128, 300) = 4), prefill_into over 128 + 128 + 44 and decode with
    one parked row, whose state and conv tail must stay bit-identical."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=2, dtype="float32")
    m_cuda, m_plain = _model_pair(torch, SSM_ARCH, cfg)
    rng = np.random.default_rng(SEED)
    v = cfg.vocab_size   # mamba2 pads its vocab to 50304: the padded columns read -1e9
    compare = _logit_check(torch, "ssm-model", SSM_MODEL_RTOL, width=v)

    tokens = rng.integers(0, cfg.vocab_size, (2, 300))
    compare("prefill B=2 S=300", m_cuda.prefill({"tokens": tokens})[0],
            m_plain.prefill({"tokens": tokens})[0])

    slots, max_len, chunk, slot = 3, 512, 128, 1
    prompt = rng.integers(0, cfg.vocab_size, 300)
    caches = {m: m.init_cache(slots, max_len) for m in (m_cuda, m_plain)}
    for start, n, out in _prefill_chunks(np, caches, prompt, slot, chunk):
        compare(f"prefill_into slot {slot}, chunk at {start} ({n} live)", out[m_cuda],
                out[m_plain])
    whole = {m: m.prefill({"tokens": prompt[None]})[0] for m in caches}
    for m, name in ((m_cuda, "cuda"), (m_plain, "plain")):
        rel = _rel(out[m][..., :v], whole[m][..., :v])
        print(f"[ssm-model] {name} binding: prefill_into vs whole-prompt prefill, max rel "
              f"diff {rel:.3g} (limit {SSM_MODEL_RTOL})")
        if rel > SSM_MODEL_RTOL:
            fail("ssm-model", f"{name}: chunked prefill disagrees with whole-prompt prefill")

    token = rng.integers(0, cfg.vocab_size, (slots, 1))
    pos = np.array([5, len(prompt), max_len - 1], np.int32)
    active = np.array([True, True, False])
    parked = {m: {name: buf[:, 2].clone() for name, buf in caches[m]["p0"].items()}
              for m in caches}
    out = {m: m.decode(token, caches[m], pos, active)[0] for m in caches}
    compare("decode pos [5, 300, parked]", out[m_cuda][:2], out[m_plain][:2])
    for m, name in ((m_cuda, "cuda"), (m_plain, "plain")):
        if not all(torch.equal(parked[m][name], caches[m]["p0"][name][:, 2])
                   for name in parked[m]):
            fail("ssm-model", f"{name}: decode moved the parked row's state")
    print("[ssm-model] decode: the parked row's state and conv tail bit-identical")


def phase_serve_ssm(torch) -> dict:
    """Run S (contiguous), the whole-prompt prefill of request 0, and run
    SP (paged, 25 pages) on full mamba2-780m; SP's tokens must equal S's.
    The model has no KV pool: paging changes only the scheduler's page
    bookkeeping."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import _build
    from repro_torch.launch.bundle import make_bundle

    cfg = get_config(SSM_ARCH)
    print(f"[ssm-serve] device memory allocated before the SSM runs: "
          f"{torch.cuda.memory_allocated()} bytes")
    runtime = Runtime()
    container = runtime.deploy(make_bundle(SSM_ARCH), device="cuda")
    for r in container.binding.reports:
        print(f"[ssm-serve] bind {r.op:<18} swapped={r.swapped} provider={r.bound} ({r.reason})")
        if not (r.swapped and r.bound == "cuda"):
            fail("ssm-serve", f"op {r.op} is not bound to its CUDA kernel: {r.reason}")
    runs = {}
    run = _drive(torch, np, cfg, container, "S contiguous")
    eng = run.pop("server").engine
    first = run["reqs"][0]
    _build.clear_launches()
    whole = eng.model.prefill({"tokens": first.prompt[None]})[0][0]
    torch.cuda.synchronize()
    whole_launches = dict(_build.LAUNCHES)
    whole_np = whole.cpu().numpy()
    print(f"[ssm-serve] Model.prefill of request 0 ({first.prompt_len} tokens, scan chunk "
          f"{math.gcd(cfg.ssm_chunk, first.prompt_len)}): logits {whole_np.shape} "
          f"finite={bool(np.isfinite(whole_np).all())}; argmax equals run S's first token "
          f"{int(np.argmax(whole_np)) == first.tokens[0]} (bf16, informational); launches "
          f"{whole_launches}")
    n = cfg.num_layers
    if not np.isfinite(whole_np).all() or whole_np.shape != (eng.model.padded_vocab,):
        fail("ssm-serve", "Model.prefill logits not finite or misshapen")
    if whole_launches != {"ssd_scan": n, "rmsnorm": n + 1}:
        fail("ssm-serve", f"whole-prompt prefill launched {whole_launches}")
    runs["S"] = run
    runs["prefill"] = whole_launches
    del eng, whole
    gc.collect()
    torch.cuda.empty_cache()
    sp = _drive(torch, np, cfg, container, "SP paged, 25 pages", paged=True, num_pages=25)
    sp.pop("server")
    gc.collect()
    torch.cuda.empty_cache()
    runs["SP"] = sp
    peak = sp["stats"]["pages-allocated-peak"]
    print(f"[ssm-serve] SP: pages-allocated-peak {int(peak)} (limit 24); tokens equal to S's: "
          f"{sp['tokens'] == run['tokens']}")
    if peak > 24:
        fail("ssm-serve", f"SP allocated {peak} pages of 24")
    if sp["tokens"] != run["tokens"]:
        fail("ssm-serve", "SP (paged) tokens differ from S's (contiguous)")
    runtime.cleanup()
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found; run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    phase_device(torch)
    phase_build()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")   # > the 50 MB L2
    cases = phase_kernels(torch, flush)
    cases.update(phase_kernel_forms(torch, flush))
    phase_kernel_edges(torch, flush)
    cases.update(phase_kernels_moe(torch, flush))
    cases.update(phase_kernels_quant(torch, flush))
    cases.update(phase_kernels_ssd(torch, flush))
    del flush
    phase_model(torch)
    torch.cuda.empty_cache()
    phase_model_quant(torch)
    serve = phase_serve(torch)
    gc.collect()
    torch.cuda.empty_cache()
    modes = phase_serve_modes(torch, serve["A"])
    gc.collect()
    torch.cuda.empty_cache()
    quant = phase_serve_quant(torch, serve["A"])
    gc.collect()
    torch.cuda.empty_cache()
    phase_model_moe(torch)
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_serve_moe(torch)
    gc.collect()
    torch.cuda.empty_cache()
    phase_model_ssm(torch)
    gc.collect()
    torch.cuda.empty_cache()
    ssm = phase_serve_ssm(torch)

    # (kernels-line entry, the run that drove it, the op it counts under)
    entries = [("rmsnorm", serve["A"], "rmsnorm"),
               ("attention", serve["whole"], "attention"),
               ("chunk_attention", serve["A"], "chunk_attention"),
               ("decode_attention", serve["A"], "decode_attention")]
    for form, run in (("paged", "B"), ("windowed", "E"), ("paged+windowed", "D")):
        for op in ("chunk_attention", "decode_attention"):
            entries.append((f"{op}/{form}", modes[run], op))
    entries.append(("windowed_attention", modes["windowed_attention"], "windowed_attention"))
    fma = moe["M"]["moe_gmm_by_kernel"]["run"]["fma"]   # run M's decode launches
    entries += [("chunk_attention/mha16", moe["M"], "chunk_attention"),
                ("decode_attention/mha16", moe["M"], "decode_attention"),
                ("moe_gmm", {"launches": moe["M"]["launches"],
                             "by_kernel": moe["M"]["moe_gmm_by_kernel"]["run"]}, "moe_gmm"),
                ("moe_gmm/decode", {"launches": {"moe_gmm": fma},
                                    "by_kernel": {"fma": fma, "tensor_core": 0}}, "moe_gmm"),
                ("moe_gmm/whole_prompt", moe["prefill"], "moe_gmm"),
                ("quant_matmul", {"launches": {"quant_matmul": quant["Q8 by kernel"]["narrow"]}},
                 "quant_matmul"),
                ("quant_matmul/chunk_w_in",
                 {"launches": {"quant_matmul": quant["Q8 by kernel"]["tensor_core"]}},
                 "quant_matmul")]
    for run, form in (("K8", "kv_int8"), ("K8P", "kv_int8+paged"), ("KF8", "kv_fp8")):
        for op in ("chunk_attention", "decode_attention"):
            entries.append((f"{op}/{form}", quant[run], op))
    entries += [("ssd_scan", ssm["S"], "ssd_scan"),
                ("ssd_scan/whole_prompt", {"launches": ssm["prefill"]}, "ssd_scan")]
    kernels = []
    for key, run, op in entries:
        kernel = op if op in SOURCES else "flash_attention"
        source, replaces = SOURCES[kernel]
        entry = {"name": key if kernel == op else f"{kernel}/{key}",
                 "route": "cuda", "source": source, "replaces": replaces,
                 "launches": run["launches"][op], **cases[key],
                 # the line is printed only when every phase passed
                 "result": "pass"}
        if kernel == "flash_attention":   # the op's launches by the kernel each took
            entry["by_kernel"] = _flash_by_kernel(run, op)
        elif "by_kernel" in run:   # moe_gmm's, as the library reported them
            entry["by_kernel"] = run["by_kernel"]
        kernels.append(entry)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "still_to_port": STILL_TO_PORT}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
