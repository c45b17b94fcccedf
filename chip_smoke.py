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
               and one PyTorch library call computing the same function.
  4. model   — full width, 2 layers, fp32: logits of the CUDA binding
               against the plain binding for prefill, prefill_into with a
               partial last chunk, and decode with a parked slot.
  5. serve   — the main path: full qwen2.5-14b (48 layers, bf16, seeded
               random weights) through Runtime.deploy -> Server, 8 requests,
               then one whole-prompt Model.prefill.  Launch counts are
               reset just before each of the two and read just after; each
               must have launched exactly the kernels its steps need.  The same whole prefill through the
               plain binding is printed beside it for scale.

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Without CUDA, or outside a checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "qwen2.5-14b"
SEED = 0
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}   # as tests/test_attention_conformance.py
MODEL_RTOL = 1e-3   # phase 4: max |cuda - plain| / max |plain| over the logits
# NVIDIA H100 SXM data sheet, dense: memory rate and peak operation rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32 = 67e12          # float32 outside the tensor cores (TF32 off)
PEAK_BF16_TC = 989e12      # bf16 on the tensor cores
SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:38"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:186"),
}
STILL_TO_PORT = [
    "src/repro/kernels/flash_attention.py:186 paged KV form",
    "src/repro/kernels/flash_attention.py:186 sliding-window form",
    "src/repro/kernels/flash_attention.py:186 quantized-KV form",
    "src/repro/kernels/quant_matmul.py:45",
    "src/repro/kernels/moe_gmm.py:102",
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


def attn_bound(b, sq, h, kv, dh, key_rows, pairs, esize, dtype_name):
    """q and o once, the key_rows K and V rows the data needs once;
    2 * Dh multiply-adds per (query, key) pair for q.k and again for p.v."""
    nbytes = (2 * b * sq * h * dh + 2 * key_rows * kv * dh) * esize
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
        b_ms, b_by = bnd
        print(f"[kernels] {op:<16} {label:<34} {dtype_name:<8} max_abs_err {err:.3g} "
              f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} bound {b_ms:.4f} ms ({b_by})")
        if main_case:
            report[op] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}

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


def phase_serve(torch) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import _build
    from repro_torch.launch.bundle import make_bundle
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models.model import Model

    cfg = get_config(ARCH)
    runtime = Runtime()
    container = runtime.deploy(make_bundle(ARCH), device="cuda")
    for r in container.binding.reports:
        print(f"[serve] bind {r.op:<18} swapped={r.swapped} provider={r.bound} ({r.reason})")
        if not (r.swapped and r.bound == "cuda"):
            fail("serve", f"op {r.op} is not bound to its CUDA kernel: {r.reason}")
    t0 = time.perf_counter()
    server = Server(cfg, container, slots=4, max_len=2048, chunk=128, device="cuda",
                    seed=SEED)
    torch.cuda.synchronize()
    eng = server.engine
    n_params = sum(p.numel() for p in eng.model.parameters())
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, {n_params} parameters in "
          f"{cfg.dtype}, seeded init in {time.perf_counter() - t0:.1f} s")

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
        if out.shape != (eng.slots, cfg.vocab_size) or not np.isfinite(out).all():
            nonfinite.append(("decode", tuple(pos)))
        return out

    eng.prefill_step, eng.decode_step = checked_prefill, checked_decode
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(64, 1537))).astype(np.int32),
                    max_new=32) for i in range(8)]

    _build.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        if not server.submit(r):
            fail("serve", f"request {r.rid} (prompt {r.prompt_len}) rejected")
    server.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)   # the serve run's launches, read just after it
    peak = torch.cuda.max_memory_allocated()
    steps = (eng.prefill_calls, eng.decode_calls)
    # the whole-prompt entry point on the same deployment, counted on its
    # own: Model.prefill of request 0's prompt
    first = reqs[0]
    _build.LAUNCHES.clear()
    whole = eng.model.prefill({"tokens": first.prompt[None]})[0][0]
    torch.cuda.synchronize()
    whole_launches = dict(_build.LAUNCHES)
    # request 0's chunked prefill replayed into slot 0, to hold the whole
    # prefill against (its launches are not counted)
    for start in range(0, first.prompt_len, eng.chunk):
        chunked = eng.prefill_step(0, first.prompt[start:start + eng.chunk], start)
    torch.cuda.synchronize()

    lens = [r.prompt_len for r in reqs]
    tokens = sum(len(r.tokens) for r in reqs)
    ttfts = sorted(r.ttft for r in reqs)
    print(f"[serve] prompts {lens}, max_new 32: {sum(r.done for r in reqs)}/{len(reqs)} "
          f"done, {tokens} tokens in {dt:.2f} s = {tokens / dt:.1f} tokens/s")
    print(f"[serve] TTFT p50 {ttfts[len(ttfts) // 2] * 1e3:.1f} ms max {ttfts[-1] * 1e3:.1f} ms"
          f" | steps prefill={steps[0]} decode={steps[1]} | peak memory "
          f"{peak} bytes")
    for kind, n in (("prefill", steps[0]), ("decode", steps[1])):
        ts = sorted(step_s[kind][:n])
        print(f"[serve] {kind} step (host clock, to logits on the host): median "
              f"{ts[len(ts) // 2] * 1e3:.1f} ms, max {ts[-1] * 1e3:.1f} ms over {n} steps, "
              f"{sum(ts):.2f} s in all")
    whole_np = whole.cpu().numpy()
    agree = int(np.argmax(whole_np)) == int(np.argmax(chunked))
    rel = float(np.abs(whole_np - chunked).max() / np.abs(chunked).max())
    print(f"[serve] Model.prefill of request 0 ({first.prompt_len} tokens): logits "
          f"{whole_np.shape} finite={bool(np.isfinite(whole_np).all())}; against its chunked "
          f"prefill: max rel diff {rel:.3g}, argmax agrees {agree} (bf16, informational)")
    print(f"[serve] launches in the serve run ({steps[0]} prefill + {steps[1]} decode "
          f"steps): {launches}")
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
    if not all(r.done and len(r.tokens) == r.max_new for r in reqs):
        fail("serve", "not every request finished with max_new tokens")
    if nonfinite:
        fail("serve", f"non-finite or misshapen logits at {nonfinite[:4]}")
    if not np.isfinite(whole_np).all() or whole_np.shape != (cfg.vocab_size,):
        fail("serve", "Model.prefill logits not finite or misshapen")
    if int(np.argmax(chunked)) != first.tokens[0]:
        fail("serve", "replayed chunked prefill does not reproduce request 0's first token")
    # every launch of the serve run is one of its steps' ops: a layer's
    # attention per step, and 2 norms per layer plus the final one
    n = cfg.num_layers
    want = {"chunk_attention": steps[0] * n, "decode_attention": steps[1] * n,
            "rmsnorm": (steps[0] + steps[1]) * (2 * n + 1)}
    if launches != {op: k for op, k in want.items() if k}:
        fail("serve", f"serve run launched {launches}, its steps need {want}")
    if whole_launches != {"attention": n, "rmsnorm": 2 * n + 1}:
        fail("serve", f"whole-prompt prefill launched {whole_launches}")
    runtime.cleanup()
    return {**launches, "attention": whole_launches["attention"]}


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
    del flush
    phase_model(torch)
    torch.cuda.empty_cache()
    launches = phase_serve(torch)

    kernels = []
    for op in ("rmsnorm", "attention", "chunk_attention", "decode_attention"):
        kernel = "rmsnorm" if op == "rmsnorm" else "flash_attention"
        source, replaces = SOURCES[kernel]
        kernels.append({"name": kernel if op == "rmsnorm" else f"{kernel}/{op}",
                        "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[op], **cases[op],
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
