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
// (expert, first row, last row) from group_sizes on the device, reads the
// sorted rows of x in place and writes its rows of out in place.  The
// grid is the static worst case, ceil(T / BM) + E + 1 row tiles by
// ceil(F / BN) column tiles; tiles past the last group return at once.
// The one tile count beyond ceil(T / BM) + E is a tail group that zeroes
// the rows past sum(group_sizes), if the sizes fall short of T; sizes are
// clamped to [0, T] and rows to T, so no size reads or writes out of
// bounds.  Nothing reads group_sizes on the host.
//
// One block: 256 threads, a BM = 32 row by BN = 128 column output tile,
// walking D in BK = 64 steps.  The x tile (BM x BK) and the expert's
// weight tile (BK x BN) are staged in shared memory as fp32; the next
// step's tiles are loaded into registers while the current one is
// multiplied.  Warp w owns tile rows 4w..4w+3, lane l columns 4l..4l+3,
// so a thread keeps 16 fp32 sums; a warp whose rows are all past the
// group's end skips the products (decode gives most experts one row).
// Each output is one thread's fp32 sum over D in a fixed order, so two
// launches on the same inputs give the same bits, and a row's result
// does not depend on the other rows of its tile.
//
// Bound on the H100: a group of n rows against a D x F expert does
// 2 n D F operations on D F weights; at the serving shapes (decode: ~1
// row an expert; chunked prefill of 128 tokens x top-6: ~12) that is far
// below the ~295 bf16 operations a byte the card needs to be compute
// bound, so the floor is reading the weights of every expert that has
// rows, once.  Only a whole-prompt prefill (~120 rows an expert) reaches
// the operation bound.  This version does plain fp32 FMAs (no mma, no
// TMA), so the large shapes are far from the tensor cores' rate.
#include "common.cuh"

namespace {

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
// warp scan of the runs' row and tile counts gives each run's first row
// and first tile, and the lane whose run holds tile `ti` reports it.
__device__ Tile find_tile(const int* __restrict__ gs, int e, long long t, long long ti) {
  const int lane = threadIdx.x & 31;
  const int per = (e + 31) / 32;
  const int g0 = min(lane * per, e), g1 = min(g0 + per, e);
  long long rows = 0, tiles = 0;
  for (int g = g0; g < g1; ++g) {
    const long long n = min(max(static_cast<long long>(gs[g]), 0LL), t);
    rows += n;
    tiles += cdiv(n, kBM);
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
    const long long nt = cdiv(n, kBM);
    if (ti >= c && ti < c + nt) mine = Tile{g, r + (ti - c) * kBM, r + n};
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
    const long long r0 = min(total_rows, t) + (ti - total_tiles) * kBM;
    if (r0 < t) out = Tile{-1, r0, t};
  }
  out.r0 = min(out.r0, t);
  out.r1 = min(min(out.r1, out.r0 + kBM), t);
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
    const Tile found = find_tile(gs, e, t, blockIdx.x);
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

template <typename T>
int launch(const void* x, const void* w, const int* gs, void* out, long long t, int d, int f,
           int e, cudaStream_t stream) {
  if (t == 0 || f == 0) return 0;
  const long long tiles = (t + kBM - 1) / kBM + e + 1;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>((f + kBN - 1) / kBN));
  moe_gmm_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                   static_cast<const T*>(w), gs,
                                                   static_cast<T*>(out), t, d, f, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (T, D), w (E, D, F) and out (T, F) contiguous in one dtype, 16-byte
// aligned, D and F whole 16-byte vectors; group_sizes (E,) int32 on the
// device.  Launches on `stream`; returns the cudaError_t of the launch
// (0 = ok) or -1 for an unsupported dtype code.
int repro_moe_gmm_launch(int dtype, const void* x, const void* w, const int* group_sizes,
                         void* out, long long t, int d, int f, int e, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(x, w, group_sizes, out, t, d, f, e, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(x, w, group_sizes, out, t, d, f, e, s);
    default:
      return -1;
  }
}
