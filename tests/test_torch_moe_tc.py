"""moe_gmm's tensor-core arithmetic, emulated on the CPU and held against
the JAX package.

`moe_gmm_tc_kernel` (csrc/moe_gmm.cu) takes every bf16 launch of at least
E rows (prefill chunks and whole prompts).  It cannot run here, so
`tc_emulation` repeats what it does in torch: it walks the kernel's row
tiles as `find_tile` gives them (BM-row tiles of one expert, sizes
clamped to [0, T] and rows to T, a tail tile zeroing the rows past
sum(group_sizes)); in a tile it rounds x and w to bf16 (the products of
two bf16 values are exact in fp32), sums in fp32 over D in the kernel's
order (one k16 step of the mma at a time, in k order), and rounds to
bf16 once, at the store.  A row's result depends on its own row of x
only, so the 16-row slices a tile's warps skip past the group's end
change nothing here.  The emulation is held against
`repro/kernels/moe_gmm.py::moe_gmm` in interpret mode and against
`moe_gmm_ref` within TOLS (bf16), over groups of 0, 1, 15, 16, 17, 63,
64, 65 and 129 rows, every row in one expert, and sizes summing short
of T (there against JAX's references, which zero the tail, and the
Pallas kernel over the grouped rows only: its ABI has sum == T).

Also here: TOLS catches a slice skipped or a k16 step dropped at
moonshot's D; a CPU call counts no launch; and chip_smoke.py's reading
of a run's moe_gmm launches by kernel (`_gmm_by_kernel`), which fails a
run whose chunks (at least E rows) did not all take the tensor-core
kernel or whose decode ticks did not all take the FMA kernel, on stub
counts.

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

from repro.kernels.moe_gmm import moe_gmm as jax_moe_gmm
from repro.kernels.moe_gmm_ref import moe_gmm_exact as jax_moe_gmm_exact
from repro.kernels.moe_gmm_ref import moe_gmm_ref as jax_moe_gmm_ref
from repro_torch.kernels import _build
from repro_torch.kernels.moe_gmm import KERNELS, moe_gmm
from repro_torch.kernels.moe_gmm_ref import moe_gmm_exact

TOLS = {"float32": 2e-5, "bfloat16": 2e-2}   # as tests/test_torch_moe.py
BM = 128      # rows a tile, as the kernel's kTcBM
K16 = 16      # contraction an mma step
ROOT = Path(__file__).resolve().parents[1]


def _seed(*parts) -> int:
    return zlib.crc32(":".join(map(str, parts)).encode()) & 0x7FFFFFFF


def tc_tiles(sizes, t: int, bm: int = BM) -> list[tuple[int, int, int]]:
    """The kernel's live row tiles (expert, r0, r1) as find_tile gives
    them: each group's rows in tiles of `bm`, sizes clamped to [0, T], rows
    to T; expert -1 is the tail past sum(sizes), which the kernel zeroes."""
    tiles, r = [], 0
    for g, n in enumerate(sizes):
        n = min(max(int(n), 0), t)
        tiles += [(g, min(r0, t), min(r0 + bm, r + n, t)) for r0 in range(r, r + n, bm)]
        r += n
    tiles += [(-1, r0, min(r0 + bm, t)) for r0 in range(r, t, bm)]
    return [tile for tile in tiles if tile[1] < tile[2]]


def tc_emulation(x: torch.Tensor, w: torch.Tensor, sizes, *, skip_slice=None,
                 drop_k16=None) -> torch.Tensor:
    """What moe_gmm_tc_kernel stores, in bf16.  `skip_slice` (tile index,
    slice) leaves one 16-row slice of a tile unwritten and `drop_k16` skips
    one k16 step: the faults TOLS has to catch."""
    t, d = x.shape
    e, _, f = w.shape
    tiles = tc_tiles(sizes, t)
    assert len(tiles) <= math.ceil(t / BM) + e + 1          # the kernel's grid
    xb, wb = x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
    out = torch.zeros((t, f), dtype=torch.bfloat16)
    for i, (g, r0, r1) in enumerate(tiles):
        if g < 0:
            continue                                         # the tail: zeros
        acc = torch.zeros((r1 - r0, f), dtype=torch.float32)
        for k0 in range(0, d, K16):
            if k0 // K16 != drop_k16:
                acc += xb[r0:r1, k0:k0 + K16] @ wb[g, k0:k0 + K16]
        if skip_slice is not None and skip_slice[0] == i:
            s = skip_slice[1] * 16
            acc[s:s + 16] = 0
        out[r0:r1] = acc.to(torch.bfloat16)
    return out


def _inputs(seed, t, d, e, f):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    return x, w


def _np(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(got, want, tol) -> None:
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# (group sizes, T, D, F): groups across the 16-row slices, the two warps'
# interleaved slices and the 128-row tile (0, 1, 15, 16, 17, 63, 64, 65,
# 129 rows), every row in one expert (the first, the last), and sizes
# summing short of T.  D of 48, 80 and 136
# end inside a 64-wide ring stage, 136 half-way through a k16 step; F of
# 24 and 136 inside a 128-column tile, 136 in a second one (the card's
# ragged edge shapes are w [E, 80, 136] and [E, 136, 24]).
GEOMS = {
    "slices": ([0, 1, 15, 16, 17, 0, 63, 64, 65, 129], None, 48, 24),
    "slices-wide": ([17, 0, 129, 1, 65, 16], None, 80, 136),
    "one-expert-first": ([200, 0, 0, 0], None, 48, 24),
    "one-expert-last": ([0, 0, 0, 129], None, 80, 24),
    "short-sum": ([15, 0, 65, 30], 160, 48, 24),
    "short-sum-empty": ([0, 0, 0], 70, 48, 24),
    "half-k16": ([17, 0, 129, 1, 65, 16], None, 136, 24),
    "short-sum-wide": ([15, 0, 65, 30], 160, 80, 136),
}


@pytest.mark.parametrize("geom", list(GEOMS))
def test_tc_emulation_matches_jax(geom):
    sizes, t, d, f = GEOMS[geom]
    used = sum(sizes)
    t = used if t is None else t
    e = len(sizes)
    x, w = _inputs(_seed("moe-tc", geom), t, d, e, f)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    jgs = jnp.asarray(np.asarray(sizes, np.int32))
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = tc_emulation(tx, tw, sizes)
    tol = TOLS["bfloat16"]
    _close(got, jax_moe_gmm_ref(jx, jw, jgs), tol)
    _close(got, jax_moe_gmm_exact(jx, jw, jgs), tol)
    _close(got, moe_gmm_exact(tx, tw, torch.tensor(sizes, dtype=torch.int32)), tol)
    assert got[used:].eq(0).all()                           # the tail tile's zeros
    if used:
        # the Pallas kernel as tests/test_kernels.py runs it; its ABI has
        # sum == T, so it is held over the grouped rows
        want = jax_moe_gmm(jx[:used], jw, jgs, block_m=16, block_n=8, interpret=True)
        _close(got[:used], want, tol)


def test_tc_tiles_follow_the_kernel_tile_finder():
    """Tiles never mix experts, cover each group's rows once in order,
    clamp sizes past T, and add a tail tile only below T."""
    assert tc_tiles([0, 1, 128, 129, 0], 260) == [(1, 0, 1), (2, 1, 129), (3, 129, 257),
                                                  (3, 257, 258), (-1, 258, 260)]
    assert tc_tiles([300], 300) == [(0, 0, 128), (0, 128, 256), (0, 256, 300)]
    assert tc_tiles([10, 0], 300) == [(0, 0, 10), (-1, 10, 138), (-1, 138, 266),
                                      (-1, 266, 300)]
    assert tc_tiles([50, 90, -3], 100) == [(0, 0, 50), (1, 50, 100)]   # cut at T
    assert tc_tiles([], 0) == []


@pytest.mark.parametrize("fault", ["skip-slice", "drop-k16"])
def test_tols_catch_a_slice_skipped_or_a_step_dropped(fault):
    """At moonshot's D = 2048, one 16-row slice left unwritten or one k16
    step of 128 dropped moves some output by more than TOLS: the card's
    check would catch either in the kernel."""
    sizes = [0, 40, 0, 24]
    x, w = _inputs(_seed("moe-tc-fault", fault), sum(sizes), 2048, len(sizes), 16)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    want = moe_gmm_exact(tx.bfloat16(), tw.bfloat16(), torch.tensor(sizes, dtype=torch.int32))
    tol = TOLS["bfloat16"]
    _close(tc_emulation(tx, tw, sizes), want, tol)
    bad = (tc_emulation(tx, tw, sizes, skip_slice=(0, 2)) if fault == "skip-slice"
           else tc_emulation(tx, tw, sizes, drop_k16=77))
    assert not torch.allclose(bad.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [7, 8, 40])
def test_cpu_call_counts_no_launch(t, dtype):
    """A CPU tensor takes the plain version on either side of the cut (E =
    8): no count moves, by op or by (op, kernel), and no library is built."""
    e = 8
    x, w = _inputs(_seed("moe-tc-count", t), t, 16, e, 8)
    sizes = np.bincount(np.random.default_rng(t).integers(0, e, t), minlength=e)
    _build.LAUNCHES["stub"] += 1
    _build.KERNEL_LAUNCHES["stub", KERNELS[1]] += 1
    before = (dict(_build.LAUNCHES), dict(_build.KERNEL_LAUNCHES))
    out = moe_gmm(torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype),
                  torch.from_numpy(sizes.astype(np.int32)))
    assert out.shape == (t, 8) and out.dtype == dtype
    assert (dict(_build.LAUNCHES), dict(_build.KERNEL_LAUNCHES)) == before
    assert _build._lib is None
    _build.clear_launches()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _moe_run(prefill: dict, decode: dict, steps=(59, 77)) -> dict:
    total = sum(prefill.values()) + sum(decode.values())
    return {"launches": {"moe_gmm": total, "rmsnorm": 97},
            "step_kernels": {"prefill": {("moe_gmm", k): n for k, n in prefill.items()},
                             "decode": {("moe_gmm", k): n for k, n in decode.items()}},
            "steps": steps}


def test_gmm_launches_split_by_kernel_on_stub_counts():
    """Run M: 59 prefill steps and 77 decode ticks over 48 layers, three
    grouped matmuls a layer, as the library would report them."""
    smoke = _chip_smoke()
    pre, dec = 59 * 48 * 3, 77 * 48 * 3
    run = _moe_run({"tensor_core": pre}, {"fma": dec})
    assert smoke._gmm_by_kernel(run) == {
        "prefill": {"fma": 0, "tensor_core": pre}, "decode": {"fma": dec, "tensor_core": 0},
        "run": {"fma": dec, "tensor_core": pre}}


@pytest.mark.parametrize("prefill, decode, match", [
    ({"tensor_core": 8495, "fma": 1}, {"fma": 11088}, "prefill"),   # a chunk on FMAs
    ({"tensor_core": 8496}, {"fma": 11087, "tensor_core": 1}, "decode"),  # a tick on the TCs
    ({"tensor_core": 8496}, {"fma": 11087}, "are not")])            # one launch unreported
def test_gmm_launch_split_refuses_counts_it_cannot_explain(prefill, decode, match):
    smoke = _chip_smoke()
    run = _moe_run(prefill, decode)
    if match == "are not":
        run["launches"]["moe_gmm"] += 1
    with pytest.raises(smoke.PhaseError, match=match):
        smoke._gmm_by_kernel(run)
