#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (src/repro_torch) on one card and check it.

    python3 chip_smoke.py          # from the repository root, one Hopper card

Phases, each one printed line per case, each raising on failure:

  1. device  — the card's name, capability and memory, and nvidia-smi's
               name and power limit; anything but sm_90 fails.
  2. build   — builds the CUDA kernels from src/repro_torch/kernels/csrc.
  3. kernels — every CUDA kernel against its plain PyTorch version at the
               full qwen2.5-14b widths, fp32 (TF32 off) and bf16, within
               TOLS (atol = rtol), with median times (CUDA events, L2
               flushed between launches) of the kernel, the plain version
               and one PyTorch library call computing the same function;
               then the flash kernel's paged forms (shuffled tables over
               pools whose park page is poisoned, page 128 and page 16),
               windowed forms (W = 512; W >= kv_len bit-identical to no
               window) and paged + windowed forms (dead pages parked), and
               the windowed_attention op.
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
               exactly the kernels its steps need.  B's tokens must equal
               A's and D's E's.  The whole prefill through the plain binding
               is printed beside it for scale, and windowed_attention runs
               once through the deployed binding.
  6. moe     — the MoE path, the repo's moonshot-v1-16b-a3b config
               (Moonlight-16B-A3B's widths; its 48 layers and MHA 16/16
               are the repo's, not the published model's)
               (its kernel cases run with phase 3, before any model is
               built): the moe_gmm kernel against moe_gmm_exact at the expert
               shapes [64, 2048, 1408] and [64, 1408, 2048], fp32 and bf16,
               at T = 24 (decode, routed, empty experts), 768 (a 128-token
               chunk x top-6), 7896 (the whole prompt of request 0) and 768
               rows in one expert, each launch pair torch.equal; chunk and
               decode attention at its H = KV = 16 geometry; then 2 layers
               fp32, CUDA binding against plain for prefill_into and decode
               (every call <= 1024 rows, where the plain binding is
               dropless) and the CUDA binding's whole-prompt prefill (1800
               rows) against its chunked prefill, with one MoE layer run under
               torch.cuda.set_sync_debug_mode("error"): it must read nothing
               back to the host; then full moonshot (48 layers, bf16, 57.8
               GB of seeded weights) serving the same 8 requests: run M
               contiguous, one whole-prompt Model.prefill, and run MP paged
               on 25 pages.  MP's tokens must equal M's; every run launches
               exactly steps x 48 x 3 moe_gmm, steps x 48 attention and
               steps x 97 rmsnorm.

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "qwen2.5-14b"
MOE_ARCH = "moonshot-v1-16b-a3b"
GMM_PER_LAYER = 3   # w_gate, w_in, w_out: one moe_gmm launch each
SEED = 0
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}   # as tests/test_attention_conformance.py
POISON = 50.0       # park-page fill, as tests/test_attention_conformance.py
MAX_LEN = 2048      # the serve phase's slot length: 16 pages of 128
WINDOW = 512        # the windowed serve runs' and kernel cases' W
MODEL_RTOL = 1e-3   # phase 4: max |cuda - plain| / max |plain| over the logits
# NVIDIA H100 SXM data sheet, dense: memory rate and peak operation rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32 = 67e12          # float32 outside the tensor cores (TF32 off)
PEAK_BF16_TC = 989e12      # bf16 on the tensor cores
SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:38"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:186"),
    "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:102"),
}
STILL_TO_PORT = [
    "src/repro/kernels/flash_attention.py:186 quantized-KV form",
    "src/repro/kernels/quant_matmul.py:45",
    "src/repro/kernels/ssd_scan.py:91",
]


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


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate for their type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attn_bound(b, sq, h, kv, dh, key_rows, pairs, esize, dtype_name, table_bytes=0):
    """q and o once, the key_rows K and V rows the data needs once (and a
    paged call's block table); 2 * Dh multiply-adds per (query, key) pair
    for q.k and again for p.v."""
    nbytes = (2 * b * sq * h * dh + 2 * key_rows * kv * dh) * esize + table_bytes
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


def _paged_pool(torch, randn, kv, dh, page, positions, seed):
    """Page pools (P, page, KV, Dh) with a shuffled block table: row b maps
    the blocks its positions 0..positions[b] touch to distinct pages, the
    rest to the park page 0, which is filled with POISON."""
    nblocks = MAX_LEN // page
    npages = 1 + len(positions) * nblocks
    pk, pv = (randn(npages, page, kv, dh) for _ in range(2))
    pk[0], pv[0] = POISON, POISON
    perm = torch.randperm(npages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = perm.reshape(len(positions), nblocks).to(torch.int32)
    for b, p in enumerate(positions):
        table[b, p // page + 1:] = 0
    return pk, pv, table.cuda()


def _gathered(torch, pool, table, group):
    """The logical cache a table addresses, KV heads expanded, (B, H, S, Dh):
    the library call's input (built outside its timing)."""
    b, n = table.shape
    x = pool[table.long()].reshape(b, n * pool.shape[1], *pool.shape[2:])
    return x.repeat_interleave(group, dim=2).transpose(1, 2)


def phase_kernel_forms(torch, flush) -> dict:
    """The paged, windowed and paged + windowed forms of the flash kernel,
    and the windowed_attention op, against their plain versions at the full
    widths; returns the main-path cases (bf16, page 128) keyed by form."""
    import torch.nn.functional as F

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
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    c, cpos = 128, 1792
    ki = torch.arange(MAX_LEN, device="cuda")

    def finite(label, out):
        if not torch.isfinite(out.float()).all():
            fail("kernels", f"{label}: non-finite output on a live row")
        return out

    def case(key, label, dn, cuda_fn, plain_fn, lib_fn, bnd, main_case, bitwise=None):
        """Hold cuda_fn() against plain_fn(); with `bitwise` (a function of
        the same inputs at W >= kv_len and its unwindowed counterpart) the
        two must be bit-identical."""
        err = _check("kernels", f"{key} {label}", finite(f"{key} {label}", cuda_fn()),
                     plain_fn(), dn)
        if bitwise is not None:
            wide, full = bitwise[0](), bitwise[1]()
            torch.cuda.synchronize()
            if not torch.equal(wide, full):
                fail("kernels", f"{key} {label}: W >= kv_len is not bit-identical to no window")
            print(f"[kernels] {key:<32} {label:<40} {dn:<8} W >= kv_len bit-identical to "
                  "the unwindowed launch")
        _record(report, key, label, dn, err, time_ms(torch, cuda_fn, flush),
                time_ms(torch, plain_fn, flush), time_ms(torch, lib_fn, flush), bnd, main_case)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        es = torch.empty((), dtype=dtype).element_size()

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        keys = sum(p + 1 for p in positions)
        wkeys = sum(min(WINDOW, p + 1) for p in positions)
        dmask = (ki[None, :] <= pos[:, None])[:, None, None]
        wmask = dmask & (ki[None, :] > (pos - WINDOW)[:, None])[:, None, None]

        # decode over page pools, page 128 (the serve geometry) and 16 (four
        # pages per 64-key tile)
        q = randn(4, 1, h, dh)
        qt = q.transpose(1, 2)
        for page in (128, 16):
            pk, pv, table = _paged_pool(torch, randn, kv, dh, page, positions, SEED + page)
            kt, vt = _gathered(torch, pk, table, group), _gathered(torch, pv, table, group)
            tb = table.numel() * 4
            case("decode_attention/paged", f"B=4 page={page} P={pk.shape[0]}", dn,
                 lambda: ops._cuda_decode_attention(q, pk, pv, pos, table),
                 lambda: decode_attention_ref(q, pk, pv, pos, table),
                 lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=dmask),
                 attn_bound(4, 1, h, kv, dh, keys, keys, es, dn, tb),
                 dn == "bfloat16" and page == 128)
            # the same pools, windowed, with the blocks wholly below every
            # window start parked on the poisoned page
            wt = table.clone()
            for b, p in enumerate(positions):
                wt[b, :max(0, p - WINDOW) // page] = 0
            case("decode_attention/paged+windowed", f"B=4 page={page} W={WINDOW} dead parked",
                 dn, lambda: ops._cuda_decode_attention(q, pk, pv, pos, wt, WINDOW),
                 lambda: decode_attention_ref(q, pk, pv, pos, wt, WINDOW),
                 lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=wmask),
                 attn_bound(4, 1, h, kv, dh, wkeys, wkeys, es, dn, tb),
                 dn == "bfloat16" and page == 128)
            del pk, pv, kt, vt

        # decode over a contiguous cache, windowed
        kc, vc = randn(4, MAX_LEN, kv, dh), randn(4, MAX_LEN, kv, dh)
        kt = kc.repeat_interleave(group, dim=2).transpose(1, 2)
        vt = vc.repeat_interleave(group, dim=2).transpose(1, 2)
        case("decode_attention/windowed", f"B=4 W={WINDOW} Smax={MAX_LEN}", dn,
             lambda: ops._cuda_decode_attention(q, kc, vc, pos, None, WINDOW),
             lambda: decode_attention_ref(q, kc, vc, pos, None, WINDOW),
             lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=wmask),
             attn_bound(4, 1, h, kv, dh, wkeys, wkeys, es, dn), dn == "bfloat16",
             bitwise=(lambda: ops._cuda_decode_attention(q, kc, vc, pos, None, 2 * MAX_LEN),
                      lambda: ops._cuda_decode_attention(q, kc, vc, pos)))
        del kc, vc, kt, vt

        # chunk C=128 at pos 1792: paged (the last block parked), windowed,
        # paged + windowed with the dead blocks parked
        q = randn(1, c, h, dh)
        qt = q.transpose(1, 2)
        lim = cpos + torch.arange(c, device="cuda")[:, None]
        cmask = (ki[None, :] <= lim)[None, None]
        cwmask = cmask & (ki[None, :] > lim - WINDOW)[None, None]
        pairs = c * cpos + c * (c + 1) // 2
        wpairs = sum(min(WINDOW, cpos + i + 1) for i in range(c))
        wrows = cpos + c - max(0, cpos - WINDOW + 1)
        pk, pv, table = _paged_pool(torch, randn, kv, dh, 128, (cpos + c - 1,), SEED + 3)
        kt, vt = _gathered(torch, pk, table, group), _gathered(torch, pv, table, group)
        tb = table.numel() * 4
        case("chunk_attention/paged", f"C={c} pos={cpos} page=128", dn,
             lambda: ops._cuda_chunk_attention(q, pk, pv, cpos, table),
             lambda: chunk_attention_ref(q, pk, pv, cpos, table),
             lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=cmask),
             attn_bound(1, c, h, kv, dh, cpos + c, pairs, es, dn, tb), dn == "bfloat16")
        wt = table.clone()
        wt[0, :max(0, cpos - WINDOW) // 128] = 0
        case("chunk_attention/paged+windowed", f"C={c} pos={cpos} W={WINDOW} dead parked", dn,
             lambda: ops._cuda_chunk_attention(q, pk, pv, cpos, wt, WINDOW),
             lambda: chunk_attention_ref(q, pk, pv, cpos, wt, WINDOW),
             lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=cwmask),
             attn_bound(1, c, h, kv, dh, wrows, wpairs, es, dn, tb), dn == "bfloat16",
             bitwise=(lambda: ops._cuda_chunk_attention(q, pk, pv, cpos, table, 2 * MAX_LEN),
                      lambda: ops._cuda_chunk_attention(q, pk, pv, cpos, table)))
        kc, vc = (x[table.long()].reshape(1, MAX_LEN, kv, dh) for x in (pk, pv))
        case("chunk_attention/windowed", f"C={c} pos={cpos} W={WINDOW} Smax={MAX_LEN}", dn,
             lambda: ops._cuda_chunk_attention(q, kc, vc, cpos, None, WINDOW),
             lambda: chunk_attention_ref(q, kc, vc, cpos, None, WINDOW),
             lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=cwmask),
             attn_bound(1, c, h, kv, dh, wrows, wpairs, es, dn), dn == "bfloat16")
        del pk, pv, kc, vc, kt, vt

        # windowed_attention: whole-prompt sliding-window prefill
        s = MAX_LEN
        q, k, v = randn(1, s, h, dh), randn(1, s, kv, dh), randn(1, s, kv, dh)
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(group, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(group, dim=2).transpose(1, 2)
        smask = ((ki[None, :] <= ki[:, None]) & (ki[None, :] > ki[:, None] - WINDOW))[None, None]
        spairs = sum(min(WINDOW, i + 1) for i in range(s))
        case("windowed_attention", f"B=1 S={s} W={WINDOW}", dn,
             lambda: ops._cuda_windowed_attention(q, k, v, WINDOW),
             lambda: windowed_attention_ref(q, k, v, WINDOW),
             lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=smask),
             attn_bound(1, s, h, kv, dh, s, spairs, es, dn), dn == "bfloat16",
             bitwise=(lambda: ops._cuda_windowed_attention(q, k, v, 2 * s),
                      lambda: ops._cuda_attention(q, k, v, causal=True)))
        del q, k, v, qt, kt, vt
    return report


def _rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_model(torch) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.launch.bundle import make_bundle
    from repro_torch.models.model import Model

    import numpy as np

    cfg = dataclasses.replace(get_config(ARCH), num_layers=2, dtype="float32")
    runtime = Runtime()
    cuda = runtime.deploy(make_bundle(ARCH), device="cuda")
    runtime.cleanup()
    plain = runtime.deploy(make_bundle(ARCH), device="cuda", native_ops=False)
    runtime.cleanup()
    m_cuda = Model(cfg, cuda.binding, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    m_plain = Model(cfg, plain.binding, device="cuda").load_params(
        dict(m_cuda.named_parameters()))
    rng = np.random.default_rng(SEED)

    def compare(label, a, b):
        rel = _rel(a, b)
        ok = bool(torch.isfinite(a).all()) and rel <= MODEL_RTOL
        print(f"[model] {label:<44} logits {tuple(a.shape)} max|cuda-plain|/max|plain| "
              f"{rel:.3g} (limit {MODEL_RTOL})")
        if not ok:
            fail("model", f"{label}: relative error {rel:.3g} (or non-finite logits)")

    tokens = rng.integers(0, cfg.vocab_size, (2, 300))
    compare("prefill B=2 S=300", m_cuda.prefill({"tokens": tokens})[0],
            m_plain.prefill({"tokens": tokens})[0])

    slots, max_len, chunk, slot = 3, 512, 128, 1
    prompt = rng.integers(0, cfg.vocab_size, 300)
    caches = {m: m.init_cache(slots, max_len) for m in (m_cuda, m_plain)}
    for start in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - start)
        buf = np.zeros((1, chunk), np.int64)
        buf[0, :n] = prompt[start:start + n]
        out = {m: m.prefill_into(buf, caches[m], slot, start, n)[0] for m in caches}
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


def _drive(torch, np, cfg, container, label, **engine_kw) -> dict:
    """Serve the 8 requests through a Server on `container` with the given
    engine options, its launch counts reset just before `server.run()` and
    read just after; fails unless every request finished with finite logits
    and the run launched exactly the kernels its steps need."""
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import Server

    t0 = time.perf_counter()
    server = Server(cfg, container, slots=4, max_len=MAX_LEN, chunk=128, device="cuda",
                    seed=SEED, **engine_kw)
    torch.cuda.synchronize()
    eng = server.engine
    n_params = sum(p.numel() for p in eng.model.parameters())
    print(f"[serve] {label}: {cfg.name}, {cfg.num_layers} layers, {n_params} parameters in "
          f"{cfg.dtype}, seeded init in {time.perf_counter() - t0:.1f} s, engine options "
          f"{engine_kw or 'none (contiguous)'}")

    nonfinite = []
    step_s = {"prefill": [], "decode": []}   # host clock per step; each step ends
    prefill_step, decode_step = eng.prefill_step, eng.decode_step   # in a device sync

    def checked_prefill(slot, tokens, pos):
        t = time.perf_counter()
        out = prefill_step(slot, tokens, pos)
        step_s["prefill"].append(time.perf_counter() - t)
        if not np.isfinite(out).all():
            nonfinite.append(("prefill", slot, pos))
        return out

    def checked_decode(tokens, pos, active):
        t = time.perf_counter()
        out = decode_step(tokens, pos, active)
        step_s["decode"].append(time.perf_counter() - t)
        # parked rows' logits are garbage by contract: check the live ones
        if out.shape != (eng.slots, cfg.vocab_size) or not np.isfinite(out[active]).all():
            nonfinite.append(("decode", tuple(pos)))
        return out

    eng.prefill_step, eng.decode_step = checked_prefill, checked_decode
    reqs = _requests(np, cfg)
    _build.LAUNCHES.clear()
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
    for kind, n in (("prefill", steps[0]), ("decode", steps[1])):
        ts = sorted(step_s[kind][:n])
        print(f"[serve] {label}: {kind} step (host clock, to logits on the host): median "
              f"{ts[len(ts) // 2] * 1e3:.1f} ms, max {ts[-1] * 1e3:.1f} ms over {n} steps, "
              f"{sum(ts):.2f} s in all")
    print(f"[serve] {label}: launches in the serve run ({steps[0]} prefill + {steps[1]} "
          f"decode steps): {launches}")
    if not all(r.done and len(r.tokens) == r.max_new for r in reqs):
        fail("serve", f"{label}: not every request finished with max_new tokens")
    if nonfinite:
        fail("serve", f"{label}: non-finite or misshapen logits at {nonfinite[:4]}")
    # every launch of the run is one of its steps' ops: a layer's attention
    # per step, 2 norms per layer plus the final one, and a MoE layer's
    # three grouped matmuls
    n = cfg.num_layers
    want = {"chunk_attention": steps[0] * n, "decode_attention": steps[1] * n,
            "rmsnorm": (steps[0] + steps[1]) * (2 * n + 1),
            "moe_gmm": (steps[0] + steps[1]) * n * GMM_PER_LAYER if cfg.num_experts else 0}
    if launches != {op: k for op, k in want.items() if k}:
        fail("serve", f"{label}: serve run launched {launches}, its steps need {want}")
    return {"server": server, "reqs": reqs, "launches": launches, "stats": stats,
            "tokens": [list(r.tokens) for r in reqs]}


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
    _build.LAUNCHES.clear()
    whole = eng.model.prefill({"tokens": first.prompt[None]})[0][0]
    torch.cuda.synchronize()
    whole_launches = dict(_build.LAUNCHES)
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
    runtime.cleanup()
    return {"A": run, "attention": whole_launches["attention"]}


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
    _build.LAUNCHES.clear()
    out = container.binding["windowed_attention"](q, k, v, WINDOW)
    torch.cuda.synchronize()
    wlaunches = dict(_build.LAUNCHES)
    print(f"[serve] binding['windowed_attention'] S={MAX_LEN} W={WINDOW}: launches {wlaunches}")
    if wlaunches != {"windowed_attention": 1} or not torch.isfinite(out.float()).all():
        fail("serve", f"windowed_attention through the binding launched {wlaunches}")
    runtime.cleanup()
    return {**runs, "windowed_attention": wlaunches["windowed_attention"]}


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
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention_ref import chunk_attention_ref, decode_attention_ref
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.moe_gmm_ref import moe_gmm_exact

    cfg = get_config(MOE_ARCH)
    d, e, f, k = cfg.d_model, cfg.num_experts, cfg.expert_d_ff, cfg.top_k
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    report = {}
    one = torch.zeros(e, dtype=torch.int32, device="cuda")
    one[17] = 768
    # (label, group sizes): decode of 4 slots, a 128-token chunk, request
    # 0's whole 1316-token prompt (above the plain binding's 1024-row
    # dropless limit: the kernel stays dropless), every row in one expert
    cases = [("T=24 decode", _routed_sizes(torch, gen, 4, e, k)),
             ("T=768 chunk", _routed_sizes(torch, gen, 128, e, k)),
             ("T=7896 whole prompt", _routed_sizes(torch, gen, 1316, e, k)),
             ("T=768 one expert", one)]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        es = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_BF16_TC if dn == "bfloat16" else PEAK_FP32
        for din, dout in ((d, f), (f, d)):
            # the scaled init's spread, so fp32 sums over D stay inside TOLS
            w = (torch.randn((e, din, dout), generator=gen, device="cuda") / din ** 0.5).to(dtype)
            for label, gs in cases:
                t = int(gs.sum())
                x = torch.randn((t, din), generator=gen, device="cuda").to(dtype)
                full = f"{label} w [{e}, {din}, {dout}]"
                got = moe_gmm(x, w, gs)
                want = moe_gmm_exact(x, w, gs)
                err = _check("kernels", f"moe_gmm {full}", got, want, dn)
                again = moe_gmm(x, w, gs)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail("kernels", f"moe_gmm {full} {dn}: two launches differ")
                lib = _library_gmm(torch, x, w, gs, want, dn)
                used = int((gs > 0).sum())
                nbytes = (t * din + t * dout) * es + used * din * dout * es + e * 4
                _record(report, "moe_gmm", full + f" ({used} experts used)", dn, err,
                        time_ms(torch, lambda: moe_gmm(x, w, gs), flush),
                        time_ms(torch, lambda: moe_gmm_exact(x, w, gs), flush),
                        None if lib is None else time_ms(torch, lib, flush),
                        bound_ms(nbytes, 2 * t * din * dout, peak),
                        dn == "bfloat16" and label == "T=768 chunk" and din == d)
                del x, got, again, want
            print(f"[kernels] moe_gmm {dn} w [{e}, {din}, {dout}]: every case bit-identical "
                  "over two launches")
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
    from repro_torch.core.runtime import Runtime
    from repro_torch.launch.bundle import make_bundle
    from repro_torch.models.model import Model
    from repro_torch.models.moe import moe_apply

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=2, dtype="float32")
    runtime = Runtime()
    cuda = runtime.deploy(make_bundle(MOE_ARCH), device="cuda")
    runtime.cleanup()
    plain = runtime.deploy(make_bundle(MOE_ARCH), device="cuda", native_ops=False)
    runtime.cleanup()
    m_cuda = Model(cfg, cuda.binding, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    m_plain = Model(cfg, plain.binding, device="cuda").load_params(
        dict(m_cuda.named_parameters()))
    rng = np.random.default_rng(SEED)

    def compare(label, a, b):
        rel = _rel(a, b)
        print(f"[moe-model] {label:<44} logits {tuple(a.shape)} max|cuda-plain|/max|plain| "
              f"{rel:.3g} (limit {MODEL_RTOL})")
        if not bool(torch.isfinite(a).all()) or rel > MODEL_RTOL:
            fail("moe-model", f"{label}: relative error {rel:.3g} (or non-finite logits)")

    slots, max_len, chunk, slot = 3, 512, 128, 1
    prompt = rng.integers(0, cfg.vocab_size, 300)
    caches = {m: m.init_cache(slots, max_len) for m in (m_cuda, m_plain)}
    for start in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - start)
        buf = np.zeros((1, chunk), np.int64)
        buf[0, :n] = prompt[start:start + n]
        out = {m: m.prefill_into(buf, caches[m], slot, start, n)[0] for m in caches}
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
        y = moe_apply(m_cuda.layers[0].moe, x, cfg, cuda.binding)
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
    _build.LAUNCHES.clear()
    whole = eng.model.prefill({"tokens": first.prompt[None]})[0][0]
    torch.cuda.synchronize()
    whole_launches = dict(_build.LAUNCHES)
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
    runs["M"] = m
    runs["prefill"] = whole_launches
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
    cases.update(phase_kernels_moe(torch, flush))
    del flush
    phase_model(torch)
    torch.cuda.empty_cache()
    serve = phase_serve(torch)
    gc.collect()
    torch.cuda.empty_cache()
    modes = phase_serve_modes(torch, serve["A"])
    gc.collect()
    torch.cuda.empty_cache()
    phase_model_moe(torch)
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_serve_moe(torch)

    # (kernels-line entry, the run that drove it, the op it counts under)
    entries = [("rmsnorm", serve["A"], "rmsnorm"),
               ("attention", {"launches": {"attention": serve["attention"]}}, "attention"),
               ("chunk_attention", serve["A"], "chunk_attention"),
               ("decode_attention", serve["A"], "decode_attention")]
    for form, run in (("paged", "B"), ("windowed", "E"), ("paged+windowed", "D")):
        for op in ("chunk_attention", "decode_attention"):
            entries.append((f"{op}/{form}", modes[run], op))
    entries.append(("windowed_attention",
                    {"launches": {"windowed_attention": modes["windowed_attention"]}},
                    "windowed_attention"))
    entries += [("chunk_attention/mha16", moe["M"], "chunk_attention"),
                ("decode_attention/mha16", moe["M"], "decode_attention"),
                ("moe_gmm", moe["M"], "moe_gmm")]
    kernels = []
    for key, run, op in entries:
        kernel = op if op in ("rmsnorm", "moe_gmm") else "flash_attention"
        source, replaces = SOURCES[kernel]
        kernels.append({"name": kernel if kernel == op else f"{kernel}/{key}",
                        "route": "cuda", "source": source, "replaces": replaces,
                        "launches": run["launches"][op], **cases[key],
                        # the line is printed only when every phase passed
                        "result": "pass"})
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "still_to_port": STILL_TO_PORT}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
