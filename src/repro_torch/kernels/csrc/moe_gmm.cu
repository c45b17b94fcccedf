// Dropless grouped (ragged) expert matmul: out[i, :] = x[i, :] @ w[e(i)],
// rows of x sorted by expert, group_sizes partitioning them.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm.py::moe_gmm
// (_gmm_kernel, padded_layout).  The TPU needs static tiles, so its
// wrapper pads every group to a multiple of block_m in a copy of x, builds
// a tile -> expert table on the host side of the trace, runs a grid over
// (tiles, F / block_n, D / block_k) with the contraction minor and the
// fp32 sum carried in VMEM scratch, and scatters the padded output back.
// Here nothing is padded or copied: each thread block finds its own tile
// (expert, first row, last row) from group_sizes on the device
// (find_tile), reads the sorted rows of x in place and writes its rows of
// out in place.  A row tile holds rows of one expert only.  The grid is
// the static worst case, ceil(T / BM) + E + 1 row tiles by ceil(F / BN)
// column tiles; tiles past the last group return at once.  The one tile
// count beyond ceil(T / BM) + E is a tail group that zeroes the rows past
// sum(group_sizes), if the sizes fall short of T; sizes are clamped to
// [0, T] and rows to T, so no size reads or writes out of bounds.
// Nothing reads group_sizes on the host.
//
// Two kernels; launch_rows is the one place that picks between them, by
// the dtype, T and E alone, and the entry point reports which it
// launched:
//
//   * moe_gmm_tc_kernel — bf16 launches of at least E rows (prefill
//     chunks, whole prompts).  A group of n rows against a D x F expert
//     does 2 n D F operations on D F weight elements: a chunk of 128
//     tokens x top-6 (~12 rows an expert) is ~12 operations a weight byte,
//     far below the ~295 a byte the card needs to be compute bound, so it
//     is bound by reading every used expert's weights once; a whole
//     prompt (~120 rows an expert) is near the line, out of reach of fp32
//     FMAs (at 67 TFLOP/s its operations take 5x its bytes' time at 3.35
//     TB/s).  So the products run on the bf16 tensor cores with fp32
//     sums, and the weights stream through a ring of three BK = 64 steps,
//     two in flight while one is multiplied.  mma.sync.m16n8k16, not
//     wgmma: its 16-row granularity lets a block skip the slices past its
//     group's end (a chunk's groups fill one slice of a 128-row tile).
//     One block: 8 warps, a BM = 128 row by BN = 128 column tile (a whole
//     prompt's group is one or two tiles); warp (m, n) owns columns 32 n
//     .. 32 n + 31 and the 16-row slices m, m + 2, ..., loads its B
//     fragments once a k16 step (ldmatrix.trans: w is F-minor) and reuses
//     them over its live slices.  x and w go to shared memory as bf16 by
//     16-byte cp.async, in 16-byte chunks swizzled by the row (swz), rows
//     past the group's end and columns past D and F zero; two blocks an
//     SM.  The grid runs column tiles fastest, so a row tile's x rows and
//     an expert's weights are each read from device memory about once.
//     Each output is one fixed-order fp32 sum over D (k16 steps in
//     order), rounded to bf16 once at the store: no split-K, no atomics,
//     and a row's result does not depend on the other rows of its tile.
//     What bounds it now, on an H100 SXM at 700 W: a chunk reads its
//     weights within 1.3x of the byte bound; a whole prompt takes about
//     twice its byte bound and under a fifth of the bf16 peak: mma.sync
//     from 16 warps an SM, with two steps of copies in flight, reaches
//     neither (a wgmma consumer with a deeper ring is the next step).
//   * moe_gmm_kernel — fp32 launches, and bf16 launches of fewer rows than
//     experts (decode: ~1 row an expert, most experts empty).  fp32 FMAs,
//     a BM = 32 row by BN = 128 column tile, walking D in BK = 64 steps;
//     the x tile (BM x BK) and the expert's weight tile (BK x BN) are
//     staged in shared memory as fp32, the next step's tiles loaded into
//     registers while the current one is multiplied.  Warp w owns tile
//     rows 4w..4w+3, lane l columns 4l..4l+3, so a thread keeps 16 fp32
//     sums; a warp whose rows are all past the group's end skips the
//     products.  Each output is one thread's fp32 sum over D in a fixed
//     order.
//
// Both give the same bits on two launches with the same inputs.
#include <type_traits>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;
using repro::smem_addr;
using repro::swz;

// moe_gmm_kernel's tile
constexpr int kBM = 32;        // rows per tile
constexpr int kBN = 128;       // columns per tile
constexpr int kBK = 64;        // contraction step
constexpr int kThreads = 256;  // 8 warps x 4 rows
constexpr int kRowsPerWarp = kBM / (kThreads / 32);

// The block's tile: expert (-1 zero-fills, -2 dead) and its rows [r0, r1).
struct Tile {
  int expert;
  long long r0, r1;
};

__device__ __forceinline__ long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Run by warp 0.  Lane l takes a contiguous run of experts; an inclusive
// warp scan of the runs' row and tile counts (BM rows a tile) gives each
// run's first row and first tile, and the lane whose run holds tile `ti`
// reports it.
template <int BM>
__device__ Tile find_tile(const int* __restrict__ gs, int e, long long t, long long ti) {
  const int lane = threadIdx.x & 31;
  const int per = (e + 31) / 32;
  const int g0 = min(lane * per, e), g1 = min(g0 + per, e);
  long long rows = 0, tiles = 0;
  for (int g = g0; g < g1; ++g) {
    const long long n = min(max(static_cast<long long>(gs[g]), 0LL), t);
    rows += n;
    tiles += cdiv(n, BM);
  }
  long long rows_incl = rows, tiles_incl = tiles;
  for (int off = 1; off < 32; off <<= 1) {
    const long long r = __shfl_up_sync(0xffffffffu, rows_incl, off);
    const long long c = __shfl_up_sync(0xffffffffu, tiles_incl, off);
    if (lane >= off) {
      rows_incl += r;
      tiles_incl += c;
    }
  }
  const long long total_rows = __shfl_sync(0xffffffffu, rows_incl, 31);
  const long long total_tiles = __shfl_sync(0xffffffffu, tiles_incl, 31);
  Tile mine{-2, 0, 0};
  long long r = rows_incl - rows, c = tiles_incl - tiles;
  for (int g = g0; g < g1; ++g) {
    const long long n = min(max(static_cast<long long>(gs[g]), 0LL), t);
    const long long nt = cdiv(n, BM);
    if (ti >= c && ti < c + nt) mine = Tile{g, r + (ti - c) * BM, r + n};
    r += n;
    c += nt;
  }
  const unsigned found = __ballot_sync(0xffffffffu, mine.expert != -2);
  Tile out{-2, 0, 0};
  if (found) {
    const int src = __ffs(found) - 1;
    out.expert = __shfl_sync(0xffffffffu, mine.expert, src);
    out.r0 = __shfl_sync(0xffffffffu, mine.r0, src);
    out.r1 = __shfl_sync(0xffffffffu, mine.r1, src);
  } else if (ti >= total_tiles && total_rows < t) {
    // the tail group: rows past sum(group_sizes) are zero-filled
    const long long r0 = min(total_rows, t) + (ti - total_tiles) * BM;
    if (r0 < t) out = Tile{-1, r0, t};
  }
  out.r0 = min(out.r0, t);
  out.r1 = min(min(out.r1, out.r0 + BM), t);
  return out;
}

// Raw 16-byte vectors of the next step's tiles, held in registers.
template <typename T>
struct Stage {
  static constexpr int N = repro::VecLoad<T>::N;                  // elements a vector
  static constexpr int kXVecs = kBM * kBK / N / kThreads;         // per thread
  static constexpr int kWVecs = kBK * kBN / N / kThreads;
  uint4 xv[kXVecs > 0 ? kXVecs : 1];
  uint4 wv[kWVecs];
};

// One raw vector converted to fp32 and stored to shared memory (dst is
// 16-byte aligned) in float4s.
template <typename T>
__device__ __forceinline__ void stage_vec(const uint4& v, float* dst) {
  constexpr int N = repro::VecLoad<T>::N;
  float tmp[N];
  repro::VecLoad<T>::load(reinterpret_cast<const T*>(&v), tmp);
#pragma unroll
  for (int j = 0; j < N; j += 4)
    *reinterpret_cast<float4*>(dst + j) = make_float4(tmp[j], tmp[j + 1], tmp[j + 2], tmp[j + 3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ gs,
               T* __restrict__ out, long long t, int d, int f, int e) {
  using S = Stage<T>;
  constexpr int N = S::N;
  constexpr int kXPerRow = kBK / N, kWPerRow = kBN / N;
  static_assert(kBM * kBK % (N * kThreads) == 0 && kBK * kBN % (N * kThreads) == 0,
                "tiles must split evenly over the threads");

  __shared__ Tile tile;
  __shared__ __align__(16) float xs[kBM][kBK];
  __shared__ __align__(16) float ws[kBK][kBN];

  if (threadIdx.x < 32) {
    const Tile found = find_tile<kBM>(gs, e, t, blockIdx.x);
    if (threadIdx.x == 0) tile = found;
  }
  __syncthreads();
  const Tile tl = tile;
  if (tl.expert == -2 || tl.r0 >= tl.r1) return;
  const int live = static_cast<int>(tl.r1 - tl.r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.y * kBN;
  const int rb = warp * kRowsPerWarp, c = lane * 4;

  if (tl.expert == -1) {  // tail rows: zeros
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = rb + i;
      if (row >= live) break;
      for (int col = n0 + c; col < min(n0 + kBN, f); col += 32 * 4) {
        T* o = out + (tl.r0 + row) * f + col;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = repro::from_float<T>(0.f);
      }
    }
    return;
  }

  const T* xg = x + tl.r0 * d;
  const T* wg = w + static_cast<long long>(tl.expert) * d * f;

  auto load = [&](S& st, int k0) {
#pragma unroll
    for (int i = 0; i < S::kXVecs; ++i) {
      const int v = threadIdx.x + i * kThreads;
      const int r = v / kXPerRow, k = k0 + (v % kXPerRow) * N;
      st.xv[i] = (r < live && k < d)
                     ? *reinterpret_cast<const uint4*>(xg + static_cast<long long>(r) * d + k)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < S::kWVecs; ++i) {
      const int v = threadIdx.x + i * kThreads;
      const int k = k0 + v / kWPerRow, n = n0 + (v % kWPerRow) * N;
      st.wv[i] = (k < d && n < f)
                     ? *reinterpret_cast<const uint4*>(wg + static_cast<long long>(k) * f + n)
                     : make_uint4(0, 0, 0, 0);
    }
  };
  auto stage = [&](const S& st) {
#pragma unroll
    for (int i = 0; i < S::kXVecs; ++i) {
      const int v = threadIdx.x + i * kThreads;
      stage_vec<T>(st.xv[i], &xs[v / kXPerRow][(v % kXPerRow) * N]);
    }
#pragma unroll
    for (int i = 0; i < S::kWVecs; ++i) {
      const int v = threadIdx.x + i * kThreads;
      stage_vec<T>(st.wv[i], &ws[v / kWPerRow][(v % kWPerRow) * N]);
    }
  };

  float acc[kRowsPerWarp][4] = {};
  const bool busy = rb < live;  // warp-uniform
  S st;
  load(st, 0);
  const int steps = (d + kBK - 1) / kBK;
  for (int s = 0; s < steps; ++s) {
    stage(st);
    __syncthreads();
    if (s + 1 < steps) load(st, (s + 1) * kBK);  // in flight during the products
    if (busy) {
#pragma unroll 4
      for (int kk = 0; kk < kBK; kk += 4) {
        float4 a[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          a[i] = *reinterpret_cast<const float4*>(&xs[rb + i][kk]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 b = *reinterpret_cast<const float4*>(&ws[kk + q][c]);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
            acc[i][0] = fmaf(av, b.x, acc[i][0]);
            acc[i][1] = fmaf(av, b.y, acc[i][1]);
            acc[i][2] = fmaf(av, b.z, acc[i][2]);
            acc[i][3] = fmaf(av, b.w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (!busy || n0 + c >= f) return;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (rb + i >= live) break;
    T* o = out + (tl.r0 + rb + i) * f + n0 + c;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = repro::from_float<T>(acc[i][j]);
  }
}

// --------------------------------------------------------------------------
// The tensor-core kernel: bf16, T >= E
// --------------------------------------------------------------------------
constexpr int kTcBM = 128;                   // rows a tile: 8 slices of 16
constexpr int kTcWM = 2;                     // warps along the rows, slices interleaved
constexpr int kTcBN = 128;                   // columns a tile: 4 warps x 32
constexpr int kTcBK = 64;                    // contraction a ring stage
constexpr int kTcThreads = 128 * kTcWM;      // 8 warps
constexpr int kTcStages = 3;                 // the ring: two steps in flight
constexpr int kTcSlices = kTcBM / 16 / kTcWM;  // 16-row slices a warp
constexpr int kTcWarpFrags = kTcBN / 4 / 8;  // n8 fragments a warp
constexpr int kXCpr = kTcBK / 8;             // 16-byte chunks an x row of a stage
constexpr int kWCpr = kTcBN / 8;             // 16-byte chunks a w row of a stage
constexpr int kXRows = kTcThreads / kXCpr;   // x rows a pass of the block's copies
constexpr int kWRows = kTcThreads / kWCpr;   // w rows a pass
constexpr int kXStage = kTcBM * kTcBK * 2;   // bytes
constexpr int kWStage = kTcBK * kTcBN * 2;
constexpr int kTcSmem = kTcStages * (kXStage + kWStage);
static_assert(kTcBM % (16 * kTcWM) == 0 && kTcBM % kXRows == 0 && kTcBK % kWRows == 0 &&
                  kXCpr % 8 == 0 && kWCpr % 8 == 0,
              "tile maps");

// 256 threads, two blocks an SM.  The grid is one dimension, column tiles
// fastest: the ceil(F / BN) blocks of a row tile, which share its x rows,
// run side by side, and so do the tiles of one expert, which share its
// weights, so both are read from device memory about once.
__global__ void __launch_bounds__(kTcThreads, 2)
moe_gmm_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, long long t,
                  int d, int f, int e) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) uint8_t tc_smem[];
  __shared__ Tile tile;
  const int ncol = (f + kTcBN - 1) / kTcBN;
  if (threadIdx.x < 32) {
    const Tile found = find_tile<kTcBM>(gs, e, t, blockIdx.x / ncol);
    if (threadIdx.x == 0) tile = found;
  }
  __syncthreads();
  const Tile tl = tile;
  if (tl.expert == -2 || tl.r0 >= tl.r1) return;
  const int live = static_cast<int>(tl.r1 - tl.r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wn = warp & 3, wm = warp >> 2;  // column quarter, row group
  const int n0 = (blockIdx.x % ncol) * kTcBN;

  if (tl.expert == -1) {  // tail rows: zeros, 16 bytes a store
    const int cpr = min(kTcBN, f - n0) / 8;
    for (int i = tid; i < live * cpr; i += kTcThreads)
      *reinterpret_cast<uint4*>(out + (tl.r0 + i / cpr) * f + n0 + (i % cpr) * 8) =
          make_uint4(0, 0, 0, 0);
    return;
  }

  const int rows = (live + 15) / 16 * 16;  // rows of the slices holding live rows
  const T* __restrict__ xg = x + tl.r0 * d;
  const T* __restrict__ wg = w + static_cast<long long>(tl.expert) * d * f;
  const uint32_t xs0 = smem_addr(tc_smem), ws0 = xs0 + kTcStages * kXStage;
  const int steps = (d + kTcBK - 1) / kTcBK;

  // Step s into ring stage st: thread tid copies chunk tid % 8 of x rows
  // tid / 8 + kXRows j below `rows`, and chunk tid % 16 of w rows tid / 16
  // + kWRows j; a chunk past the group, D or F is zero-filled.
  const int xc = tid % kXCpr, xr = tid / kXCpr, wc = tid % kWCpr, wr = tid / kWCpr;
  const bool wcol = n0 + wc * 8 < f;
  auto copy_step = [&](int s, int st) {
    const int k0 = s * kTcBK;
    const uint32_t xd = xs0 + st * kXStage, wd = ws0 + st * kWStage;
    const int k = k0 + xc * 8;
#pragma unroll
    for (int j = 0; j < kTcBM / kXRows; ++j) {
      const int r = xr + kXRows * j;
      if (r < rows) {
        const bool ok = r < live && k < d;
        cp_async16(xd + swz(r, xc, kXCpr), ok ? xg + static_cast<long long>(r) * d + k : xg, ok);
      }
    }
#pragma unroll
    for (int j = 0; j < kTcBK / kWRows; ++j) {
      const int kr = wr + kWRows * j;
      const bool ok = wcol && k0 + kr < d;
      cp_async16(wd + swz(kr, wc, kWCpr),
                 ok ? wg + static_cast<long long>(k0 + kr) * f + n0 + wc * 8 : wg, ok);
    }
  };

  // warp (wm, wn): slices wm + 2 i, columns 32 wn .. 32 wn + 31
  float acc[kTcSlices][kTcWarpFrags][4] = {};  // slice, n8 fragment, mma element
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < steps) copy_step(s, s);
    cp_async_commit();
  }
  int st = 0;  // step s's ring stage
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kTcStages - 2>();  // step s landed ...
    __syncthreads();                 // ... for every thread; step s - 1 consumed
    const int next = s + kTcStages - 1;  // into the stage step s - 1 used
    if (next < steps) copy_step(next, st == 0 ? kTcStages - 1 : st - 1);
    cp_async_commit();
    const uint32_t xs = xs0 + st * kXStage, wsm = ws0 + st * kWStage;
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      // this warp's B fragments of the k16 step: w rows 16 kk .. 16 kk + 15,
      // two n8 fragments an ldmatrix
      uint32_t b[kTcWarpFrags][2];
#pragma unroll
      for (int h = 0; h < kTcWarpFrags / 2; ++h) {
        uint32_t r[4];
        ldsm_x4_trans(r, wsm + swz(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                   wn * kTcWarpFrags + 2 * h + (lane >> 4), kWCpr));
        b[2 * h][0] = r[0];
        b[2 * h][1] = r[1];
        b[2 * h + 1][0] = r[2];
        b[2 * h + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kTcSlices; ++i) {
        const int sl = wm + kTcWM * i;
        if (sl * 16 < rows) {
          uint32_t a[4];
          ldsm_x4(a, xs + swz(sl * 16 + (lane & 15), 2 * kk + (lane >> 4), kXCpr));
#pragma unroll
          for (int n = 0; n < kTcWarpFrags; ++n) mma_bf16(acc[i][n], a, b[n][0], b[n][1]);
        }
      }
    }
    st = st == kTcStages - 1 ? 0 : st + 1;
  }
  cp_async_wait<0>();  // no copy in flight at exit

  // lane l holds rows l / 4 and l / 4 + 8 of each slice, columns 2 (l % 4)
  // + 0, 1 of each n8 fragment
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < kTcWarpFrags; ++n) {
    const int col = n0 + (wn * kTcWarpFrags + n) * 8;
    if (col >= f) continue;  // F is whole 8-column fragments
#pragma unroll
    for (int i = 0; i < kTcSlices; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm + kTcWM * i) * 16 + g + 8 * h;
        if (r < live)
          *reinterpret_cast<uint32_t*>(out + (tl.r0 + r) * f + col + 2 * t4) =
              pack_bf16(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
      }
    }
  }
}

// --------------------------------------------------------------------------
// Launches
// --------------------------------------------------------------------------

// The kernels a launch may take, as repro_moe_gmm reports them.
enum KernelId { kFmaKernel = 0, kTensorCoreKernel = 1 };

template <typename T>
int launch_fma(const void* x, const void* w, const int* gs, void* out, long long t, int d, int f,
               int e, cudaStream_t stream) {
  const long long tiles = (t + kBM - 1) / kBM + e + 1;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>((f + kBN - 1) / kBN));
  moe_gmm_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                   static_cast<const T*>(w), gs,
                                                   static_cast<T*>(out), t, d, f, e);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const void* x, const void* w, const int* gs, void* out, long long t, int d, int f,
              int e, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gmm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (t + kTcBM - 1) / kTcBM + e + 1;
  const long long blocks = tiles * ((f + kTcBN - 1) / kTcBN);
  using B = __nv_bfloat16;
  moe_gmm_tc_kernel<<<static_cast<unsigned>(blocks), kTcThreads, kTcSmem, stream>>>(
      static_cast<const B*>(x), static_cast<const B*>(w), gs, static_cast<B*>(out), t, d, f, e);
  return static_cast<int>(cudaGetLastError());
}

// The one routing rule: bf16 launches of at least E rows (prefill chunks,
// whole prompts) take the tensor cores; bf16 launches of fewer rows than
// experts (decode) and every fp32 launch the FMA kernel.  T and E alone
// decide, so the host reads no group size.
template <typename T>
int launch_rows(const void* x, const void* w, const int* gs, void* out, long long t, int d,
                int f, int e, cudaStream_t stream, int* kernel) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (t >= e) {
      *kernel = kTensorCoreKernel;
      return launch_tc(x, w, gs, out, t, d, f, e, stream);
    }
  }
  *kernel = kFmaKernel;
  return launch_fma<T>(x, w, gs, out, t, d, f, e, stream);
}

}  // namespace

// x (T, D), w (E, D, F) and out (T, F) contiguous in one dtype, 16-byte
// aligned, D and F whole 16-byte vectors; group_sizes (E,) int32 on the
// device.  Launches on `stream`; returns the cudaError_t of the launch
// (0 = ok) or -1 for an unsupported dtype code.  *kernel gets the kernel
// launched (0 moe_gmm_kernel, 1 moe_gmm_tc_kernel), or -1 when nothing was
// launched (T or F is 0, or the dtype is unsupported).
int repro_moe_gmm_launch(int dtype, const void* x, const void* w, const int* group_sizes,
                         void* out, long long t, int d, int f, int e, void* stream,
                         int* kernel) {
  *kernel = -1;
  if (t == 0 || f == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int took = -1;
  int err;
  switch (dtype) {
    case repro::kFloat32:
      err = launch_rows<float>(x, w, group_sizes, out, t, d, f, e, s, &took);
      break;
    case repro::kBFloat16:
      err = launch_rows<__nv_bfloat16>(x, w, group_sizes, out, t, d, f, e, s, &took);
      break;
    default:
      return -1;
  }
  if (err == 0) *kernel = took;
  return err;
}
