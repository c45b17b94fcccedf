// Quantized matmul: out[t, f] = (sum_k x[t, k] * code[k, f]) * scale[f],
// x (T, D) float32 or bfloat16, codes (D, F) int8 or float8_e4m3fn, one
// float32 scale an output column; fp32 sums, out (T, F) in x's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/quant_matmul.py::quant_matmul
// (_quant_matmul_kernel).  That kernel keeps the whole contraction in VMEM:
// a (block_m, D) activation tile times a (D, block_n) code tile upcast to
// fp32, one dot, then the channel scales on the product.  Here D runs in
// BK = 64 steps through shared memory, and the scales are applied to the
// finished sum, as there.
//
// Bound on the H100: the codes are 1 byte a weight, so a decode tick (T =
// 4) does 2 T = 8 operations a byte read, far below the ~295 a byte the
// card needs before its bf16 tensor cores are the limit: the floor is
// streaming the D x F codes once.  A 128-token prefill chunk does 256 a
// byte, near the line; a whole-prompt prefill (T ~ 1300) is far above it
// and bound by the tensor cores' 989 TFLOP/s.
//
// Three kernels, chosen by (x's dtype, T); all take 256 threads, a BN =
// 128 column tile and D in BK = 64 steps:
//
//   * tensor cores (bf16 x, T > 4: prefill chunks and whole prompts): a
//     128-row tile, two warpgroups of 64 rows, each multiplying with
//     wgmma.m64n128k16 (bf16 operands from shared memory, fp32 sums in
//     registers; wgmma, not mma.sync: it is the only route to the tensor
//     cores' full rate, and it came out right).  The result is the fp32
//     product up to the order of the sums: every int8 code (|c| <= 128)
//     and every finite e4m3 value (3 mantissa bits, exponents 2^-9 .. 2^8)
//     is exact in bf16, the bf16 x is exact already, and the product of
//     two bf16 values is exact in fp32.  The codes cross device memory as
//     1 byte: a ring of 6 stages, each a (128 x 64) bf16 x tile and a
//     (64 x 128) code tile, filled by 16-byte cp.async (zero-filled past T,
//     D and F), keeps four steps' copies in flight.  Each code tile is
//     converted once, with integer and bf16x2 bit operations (no
//     conversion unit; common.cuh's int8x2_to_bf16x2 and
//     e4m3x2_to_bf16x2), into one of three bf16 tiles in the K-major,
//     128-byte-swizzled layout wgmma reads; x lands in that layout
//     directly.  The staged codes are swizzled too, so the conversion's
//     reads and writes are free of bank conflicts.  Step s + 1's
//     conversion and copies run while steps s - 1 and s multiply.  A
//     128-token chunk reads each code tile from device memory once, and
//     the grid runs row tiles fastest, so a whole prompt's row tiles share
//     each code tile in L2.  One block an SM (193 KB of shared memory).
//     What bounds it (clock64 stamps in a development build on an H100):
//     a warp that issues wgmma is held until the tensor cores take the
//     group, and a step's products and its copies and conversion, about
//     equally long when run alone, share the SM's shared memory, so a
//     step takes about their sum; moving the copies and conversion to
//     warps of their own did not shorten it.  Fewer shared-memory bytes a
//     product (a wider column tile, codes decoded from registers) are the
//     next lever.
//   * rows (fp32 x, T > 4: the tests and the fp32 model phase): a 32-row
//     tile of fp32 FMAs; the step's codes (16-byte vectors along F,
//     coalesced) and x tile are staged in shared memory as fp32; warp w
//     owns rows 4w..4w+3, lane l columns 4l..4l+3 (16 sums a thread), as
//     moe_gmm.cu; the next step is in flight during the products.  It
//     stays on FMAs: TF32 would keep ~10 bits of x, outside fp32's
//     tolerance, and fp32 x runs in no bf16 serve run.
//   * narrow (T <= 4: a decode tick of 4 slots, the LM head of one token):
//     a 4-row tile; warp w owns k rows 8w..8w+7 of every step, lane l
//     columns 4l..4l+3, all 4 rows (16 sums a thread).  Each code is used
//     by one thread only, so the codes go from device memory to that
//     thread's registers (a 32-bit word a k row; a warp reads 128
//     contiguous bytes) and are converted there, with no shared-memory
//     staging; only the small x tile goes through shared memory.  Its work
//     is streaming the codes, so two steps more are in flight.  At the end
//     the 8 warps' sums are added in shared memory in warp order.  A
//     product of 4 rows would waste 60 of wgmma's 64.
//
// Filling the card: a decode tick's w_out (F = 5120) has 40 column tiles
// for 132 SMs, a chunk's 40 too (the tensor-core kernel holds one block an
// SM, so a chunk's w_out runs in 3 ranges and its w_in, 108 column tiles,
// in one).  The wrapper splits D into equal ranges
// (blockIdx.z), as many as one wave of resident blocks holds;
// repro_quant_matmul_occupancy gives it the row tile, the blocks of the
// kernel a launch takes resident on an SM and the card's SM count.  Each
// range writes its fp32 partial sums to a workspace, and a second kernel
// adds the ranges in order and applies the scales.  No atomics: every
// output is the same fixed-order sum on every launch, so two launches give
// the same bits.
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBN = 128;       // columns per tile
constexpr int kBK = 64;        // contraction step
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;      // rows per tile of the fp32 row kernel
constexpr int kNarrow = 4;     // rows per tile of the narrow kernel
constexpr int kCodesPerVec = 16;

// code type tags: int8 or e4m3
struct Int8 {};
struct E4M3 {};

// 4 codes of one 32-bit word (lowest byte first) to fp32, exactly.
template <typename Q>
__device__ __forceinline__ void word_to_float(uint32_t w, float* out);

template <>
__device__ __forceinline__ void word_to_float<Int8>(uint32_t w, float* out) {
  repro::int8x4_to_float(w, out);
}

template <>
__device__ __forceinline__ void word_to_float<E4M3>(uint32_t w, float* out) {
  repro::e4m3x4_to_float(w, out);
}

// 16 codes of one raw vector to fp32.
template <typename Q>
__device__ __forceinline__ void codes_to_float(const uint4& v, float* out) {
  word_to_float<Q>(v.x, out);
  word_to_float<Q>(v.y, out + 4);
  word_to_float<Q>(v.z, out + 8);
  word_to_float<Q>(v.w, out + 12);
}

// Raw 16-byte vectors of one k step's tiles of the row kernel, held in
// registers.
template <typename T>
struct Stage {
  static constexpr int N = repro::VecLoad<T>::N;              // x elements a vector
  static constexpr int kXTotal = kRows * kBK / N;
  static constexpr int kXVecs = (kXTotal + kThreads - 1) / kThreads;  // per thread
  static constexpr int kQVecs = kBK * kBN / kCodesPerVec / kThreads;
  uint4 xv[kXVecs];
  uint4 qv[kQVecs];
};

// The block's place: rows [row0, row0 + live), columns [n0, n0 + kBN),
// contraction [k_begin, k_end).
struct Place {
  long long row0;
  int live, n0, k_begin, k_end;
};

__device__ __forceinline__ Place place(long long t, int d, int kchunk, int bm,
                                       unsigned row_tile, unsigned col_tile) {
  Place p;
  p.row0 = static_cast<long long>(row_tile) * bm;
  p.live = static_cast<int>(min(static_cast<long long>(bm), t - p.row0));
  p.n0 = col_tile * kBN;
  p.k_begin = blockIdx.z * kchunk;
  p.k_end = min(d, p.k_begin + kchunk);
  return p;
}

// Loads the tiles of the k step at k0 into registers; rows past the
// tile's live rows and k past the range read as zeros.
template <typename T>
__device__ __forceinline__ void load(Stage<T>& st, const T* __restrict__ x,
                                     const uint8_t* __restrict__ q, const Place& p, int d,
                                     int f, int k0) {
  using S = Stage<T>;
  constexpr int kXPerRow = kBK / S::N, kQPerRow = kBN / kCodesPerVec;
#pragma unroll
  for (int i = 0; i < S::kXVecs; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int r = v / kXPerRow, k = k0 + (v % kXPerRow) * S::N;
    st.xv[i] = (v < S::kXTotal && r < p.live && k < p.k_end)
                   ? *reinterpret_cast<const uint4*>(x + (p.row0 + r) * d + k)
                   : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < S::kQVecs; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int k = k0 + v / kQPerRow, n = p.n0 + (v % kQPerRow) * kCodesPerVec;
    st.qv[i] = (k < p.k_end && n < f)
                   ? *reinterpret_cast<const uint4*>(q + static_cast<long long>(k) * f + n)
                   : make_uint4(0, 0, 0, 0);
  }
}

// Stores the step's codes to qs[kBK][kBN] as fp32.
template <typename T, typename Q>
__device__ __forceinline__ void stage_codes(const Stage<T>& st, float (*qs)[kBN]) {
  using S = Stage<T>;
  constexpr int kQPerRow = kBN / kCodesPerVec;
#pragma unroll
  for (int i = 0; i < S::kQVecs; ++i) {
    const int v = threadIdx.x + i * kThreads;
    float tmp[kCodesPerVec];
    codes_to_float<Q>(st.qv[i], tmp);
    float* dst = &qs[v / kQPerRow][(v % kQPerRow) * kCodesPerVec];
#pragma unroll
    for (int j = 0; j < kCodesPerVec; j += 4)
      *reinterpret_cast<float4*>(dst + j) = make_float4(tmp[j], tmp[j + 1], tmp[j + 2], tmp[j + 3]);
  }
}

// Four finished sums of one row: the output (one range) or the workspace.
template <typename T>
__device__ __forceinline__ void emit(const float* sum, long long row, int col,
                                     const float* __restrict__ scale, T* __restrict__ out,
                                     float* __restrict__ ws, long long t, int f, int splits) {
  if (splits == 1) {
    T* o = out + row * f + col;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = repro::from_float<T>(sum[j] * scale[col + j]);
  } else {
    float* w = ws + (static_cast<long long>(blockIdx.z) * t + row) * f + col;
    *reinterpret_cast<float4*>(w) = make_float4(sum[0], sum[1], sum[2], sum[3]);
  }
}

template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads, 3)
qmm_rows_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                const float* __restrict__ scale, T* __restrict__ out, float* __restrict__ ws,
                long long t, int d, int f, int kchunk, int splits) {
  using S = Stage<T>;
  constexpr int N = S::N, kXPerRow = kBK / N;
  constexpr int kRowsPerWarp = kRows / kWarps;
  __shared__ __align__(16) float xs[kRows][kBK];
  __shared__ __align__(16) float qs[kBK][kBN];

  const Place p = place(t, d, kchunk, kRows, blockIdx.y, blockIdx.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = warp * kRowsPerWarp, c = lane * 4;
  const bool busy = rb < p.live;  // warp-uniform

  float acc[kRowsPerWarp][4] = {};
  S st;
  load<T>(st, x, q, p, d, f, p.k_begin);
  const int steps = p.k_end > p.k_begin ? (p.k_end - p.k_begin + kBK - 1) / kBK : 0;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < S::kXVecs; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v < S::kXTotal) {
        float tmp[N];
        repro::VecLoad<T>::load(reinterpret_cast<const T*>(&st.xv[i]), tmp);
        float* dst = &xs[v / kXPerRow][(v % kXPerRow) * N];
#pragma unroll
        for (int j = 0; j < N; j += 4)
          *reinterpret_cast<float4*>(dst + j) = make_float4(tmp[j], tmp[j + 1], tmp[j + 2], tmp[j + 3]);
      }
    }
    stage_codes<T, Q>(st, qs);
    __syncthreads();
    if (s + 1 < steps) load<T>(st, x, q, p, d, f, p.k_begin + (s + 1) * kBK);
    if (busy) {
#pragma unroll 4
      for (int kk = 0; kk < kBK; kk += 4) {
        float4 a[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          a[i] = *reinterpret_cast<const float4*>(&xs[rb + i][kk]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 b = *reinterpret_cast<const float4*>(&qs[kk + u][c]);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const float av = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z : a[i].w;
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

  if (!busy || p.n0 + c >= f) return;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (rb + i >= p.live) break;
    emit<T>(acc[i], p.row0 + rb + i, p.n0 + c, scale, out, ws, t, f, splits);
  }
}

// One k step of the narrow kernel in registers: thread (warp w, lane l)
// holds the codes of its own 8 k rows (8w..8w+7) and 4 columns (4l..4l+3),
// one 32-bit word a row (a warp reads 128 contiguous bytes a row), and at
// most one 16-byte vector of the x tile.
template <typename T, int R>
struct NarrowStage {
  static constexpr int N = repro::VecLoad<T>::N;
  static constexpr int kXTotal = R * kBK / N;  // x vectors a step (<= kThreads)
  uint4 xv;
  uint32_t cw[kBK / kWarps];
};

template <typename T, int R>
__device__ __forceinline__ void narrow_load(NarrowStage<T, R>& st, const T* __restrict__ x,
                                            const uint8_t* __restrict__ q, const Place& p,
                                            int d, int f, int k0) {
  using S = NarrowStage<T, R>;
  constexpr int kXPerRow = kBK / S::N;
  const int v = threadIdx.x;
  const int r = v / kXPerRow, k = k0 + (v % kXPerRow) * S::N;
  st.xv = (v < S::kXTotal && r < p.live && k < p.k_end)
              ? *reinterpret_cast<const uint4*>(x + (p.row0 + r) * d + k)
              : make_uint4(0, 0, 0, 0);
  const int warp = threadIdx.x >> 5, n = p.n0 + (threadIdx.x & 31) * 4;
#pragma unroll
  for (int j = 0; j < kBK / kWarps; ++j) {
    const int kr = k0 + warp * (kBK / kWarps) + j;
    st.cw[j] = (kr < p.k_end && n < f)
                   ? *reinterpret_cast<const uint32_t*>(q + static_cast<long long>(kr) * f + n)
                   : 0u;
  }
}

template <typename T, typename Q, int R>
__global__ void __launch_bounds__(kThreads, 2)
qmm_narrow_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                  const float* __restrict__ scale, T* __restrict__ out, float* __restrict__ ws,
                  long long t, int d, int f, int kchunk, int splits) {
  using S = NarrowStage<T, R>;
  constexpr int N = S::N, kXPerRow = kBK / N;
  constexpr int kStepsPerWarp = kBK / kWarps;
  static_assert(S::kXTotal <= kThreads && R % 4 == 0, "one x vector a thread, float4 rows");
  __shared__ __align__(16) float xs[kBK][R];  // transposed: a k's R rows together
  __shared__ __align__(16) float red[kWarps][R][kBN];

  const Place p = place(t, d, kchunk, R, blockIdx.y, blockIdx.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane * 4;

  float acc[R][4] = {};
  const int steps = p.k_end > p.k_begin ? (p.k_end - p.k_begin + kBK - 1) / kBK : 0;
  // three register stages, used in turn (static names: a stage indexed by
  // a loop variable would go to local memory); step s's loads are issued
  // when step s - 3 ends, so two steps of codes are in flight
  S st0, st1, st2;
  narrow_load<T, R>(st0, x, q, p, d, f, p.k_begin);
  if (steps > 1) narrow_load<T, R>(st1, x, q, p, d, f, p.k_begin + kBK);
  if (steps > 2) narrow_load<T, R>(st2, x, q, p, d, f, p.k_begin + 2 * kBK);
  auto step = [&](S& st, int s) {
    if (threadIdx.x < S::kXTotal) {
      float tmp[N];
      repro::VecLoad<T>::load(reinterpret_cast<const T*>(&st.xv), tmp);
      const int r = threadIdx.x / kXPerRow, k = (threadIdx.x % kXPerRow) * N;
#pragma unroll
      for (int j = 0; j < N; ++j) xs[k + j][r] = tmp[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kStepsPerWarp; ++j) {
      const int kk = warp * kStepsPerWarp + j;
      float b[4];
      word_to_float<Q>(st.cw[j], b);
#pragma unroll
      for (int r4 = 0; r4 < R; r4 += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(&xs[kk][r4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[r4 + i][u] = fmaf(a[i], b[u], acc[r4 + i][u]);
      }
    }
    __syncthreads();
    if (s + 3 < steps) narrow_load<T, R>(st, x, q, p, d, f, p.k_begin + (s + 3) * kBK);
  };
  for (int s = 0; s < steps; s += 3) {
    step(st0, s);
    if (s + 1 < steps) step(st1, s + 1);
    if (s + 2 < steps) step(st2, s + 2);
  }

  // the warps' sums, added in warp order
#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float4*>(&red[warp][r][c]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  const int r = warp;  // this thread's output: row `warp`, columns c..c+3
  if (r >= R || r >= p.live || p.n0 + c >= f) return;
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int w = 0; w < kWarps; ++w) {
    const float4 v = *reinterpret_cast<const float4*>(&red[w][r][c]);
    sum[0] += v.x;
    sum[1] += v.y;
    sum[2] += v.z;
    sum[3] += v.w;
  }
  emit<T>(sum, p.row0 + r, p.n0 + c, scale, out, ws, t, f, splits);
}

// ---------------------------------------------------------------------------
// The tensor-core kernel: bf16 x, T > 4
// ---------------------------------------------------------------------------
constexpr int kTcRows = 128;    // rows a block: two warpgroups of 64
constexpr int kTcStages = 6;    // the cp.async ring
constexpr int kTcB = 3;         // bf16 code tiles: steps s - 1 and s multiplying, s + 1 converting
constexpr int kXTile = kTcRows * kBK * 2;  // bf16 x tile: 128 rows of 128 bytes
constexpr int kQTile = kBK * kBN;          // 1-byte code tile: 64 rows of 128 bytes
constexpr int kBTile = kBN * kBK * 2;      // bf16 code tile: 128 columns of 128 bytes
// the ring, the converted code tiles, and 1 KB to align the base to the
// swizzle's 1024-byte period
constexpr int kTcSmem = kTcStages * (kXTile + kQTile) + kTcB * kBTile + 1024;
static_assert(kThreads == 256 && kBK == 64 && kBN == 128, "the tile maps below");
static_assert(kTcStages >= 4 && kTcB == 3, "tc_mainloop's waits");

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::smem_addr;

// Makes this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a K-major tile of 8-row groups 1024 bytes apart,
// each row 128 bytes of K with its 16-byte chunks swizzled (chunk c of row
// r at c ^ (r % 8)).  Advancing K by 16 adds 32 bytes to the address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) += A (64 x 16, bf16) * B (16 x 128, bf16), both from
// shared memory, K-major.  Thread l of the warpgroup holds rows
// 16 (l / 32) + (l % 32) / 4 + 8 i and columns 8 j + 2 (l % 4) + c in
// d[4 j + 2 i + c].
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Two codes, the low bytes of t's two 16-bit halves, to a bf16 pair
// exactly (common.cuh).
template <typename Q>
__device__ __forceinline__ uint32_t pair_to_bf16x2(uint32_t t);

template <>
__device__ __forceinline__ uint32_t pair_to_bf16x2<Int8>(uint32_t t) {
  return repro::int8x2_to_bf16x2(t);
}

template <>
__device__ __forceinline__ uint32_t pair_to_bf16x2<E4M3>(uint32_t t) {
  return repro::e4m3x2_to_bf16x2(t);
}

// One thread's part of a k step's copies: 4 chunks of the x tile (128 rows
// x 8 chunks of 8 bf16, chunk c of row r at c ^ (r % 8): the layout wgmma
// reads) and 2 of the code tile (64 rows x 8 chunks of 16 codes, chunk c
// of row k at c ^ (k / 8), so that convert_codes reads without bank
// conflicts).  Thread i takes chunk c = i % 8 of rows i / 8 + 32 j, so its
// addresses are fixed but for the step's offset.  Rows past the tile's
// live rows, k past the range and columns past F are zero-filled.
struct TcLoader {
  const __nv_bfloat16* xg;  // the x chunk of row i / 8 at the range's first k
  const uint8_t* qg;        // the code chunk of k row i / 8 at the range's first k
  long long x_rows32, q_rows32;  // 32 rows further on: x and codes
  int f;
  uint32_t xdst, qdst0, qdst1;   // offsets in a slot
  int xk, qk, k_end;        // k of the x chunk and of code row i / 8 at the range's first k
  unsigned live_rows;       // bit j: x row i / 8 + 32 j is live
  bool col_ok;              // the code chunk's columns are inside F

  __device__ __forceinline__ TcLoader(const __nv_bfloat16* x, const uint8_t* q, const Place& p,
                                      int d, int f) {
    const int c = threadIdx.x & 7, r = threadIdx.x >> 3;
    xk = p.k_begin + c * 8;
    qk = p.k_begin + r;
    k_end = p.k_end;
    live_rows = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) live_rows |= (r + 32 * j < p.live ? 1u : 0u) << j;
    col_ok = p.n0 + c * 16 < f;
    xg = x + (p.row0 + r) * d + xk;
    qg = q + static_cast<long long>(qk) * f + p.n0 + c * 16;
    x_rows32 = 32LL * d;
    q_rows32 = 32LL * f;
    this->f = f;
    xdst = r * 128 + ((c ^ (r & 7)) << 4);
    qdst0 = r * 128 + ((c ^ (r >> 3)) << 4);
    qdst1 = (r + 32) * 128 + ((c ^ ((r + 32) >> 3)) << 4);
  }

  // the copies of the range's step `step` into the slot at xs (x) and qs (codes)
  __device__ __forceinline__ void load(uint32_t xs, uint32_t qs, int step,
                                       const __nv_bfloat16* x, const uint8_t* q) const {
    const int k0 = step * kBK;
    const bool xk_ok = xk + k0 < k_end;
    const __nv_bfloat16* xp = xg + k0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = xk_ok && (live_rows >> j & 1u);
      cp_async16(xs + xdst + j * 32 * 128, ok ? xp + j * x_rows32 : x, ok);
    }
    const uint8_t* qp = qg + static_cast<long long>(k0) * f;
    const bool ok0 = col_ok && qk + k0 < k_end, ok1 = col_ok && qk + k0 + 32 < k_end;
    cp_async16(qs + qdst0, ok0 ? qp : q, ok0);
    cp_async16(qs + qdst1, ok1 ? qp + q_rows32 : q, ok1);
  }
};

// Converts a staged code tile (64 k x 128 columns) into the bf16 tile
// wgmma reads as B: column n's 64 k values as row n of 128 bytes, chunk
// c (k = 8c .. 8c + 7) at c ^ (n % 8).  Lane l of warp w takes k rows
// 8 (l % 8) .. + 7 of columns 4 g .. 4 g + 3, g = 4 w + l / 8: its eight
// 32-bit reads are one per bank across the warp, and each 16-byte store
// of 8 lanes lands in 8 distinct chunks.
template <typename Q>
__device__ __forceinline__ void convert_codes(const uint8_t* qs, uint8_t* bs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = lane & 7, g = warp * 4 + (lane >> 3);
  const uint8_t* src = qs + kg * 8 * kBN + ((((g >> 2) ^ kg) << 4) | ((g & 3) << 2));
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = *reinterpret_cast<const uint32_t*>(src + i * kBN);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = g * 4 + j;
    const uint32_t sel = j | ((4 + j) << 8);  // byte j of each word of a pair
    uint4 v;
    v.x = pair_to_bf16x2<Q>(__byte_perm(w[0], w[1], sel));
    v.y = pair_to_bf16x2<Q>(__byte_perm(w[2], w[3], sel));
    v.z = pair_to_bf16x2<Q>(__byte_perm(w[4], w[5], sel));
    v.w = pair_to_bf16x2<Q>(__byte_perm(w[6], w[7], sel));
    *reinterpret_cast<uint4*>(bs + n * 128 + ((kg ^ (n & 7)) << 4)) = v;
  }
}

// The k loop of the tensor-core kernel.  Step s: issue step s's products
// (kMultiply: a warpgroup with live rows), wait for step s - 2's, then,
// past a barrier, convert step s + 1's codes into the bf16 tile step s - 2
// read and refill the ring slot step s - 2 used, while steps s - 1 and s
// multiply.  Every thread runs every barrier; the accumulators are touched
// by nothing but wgmma inside the loop, so the compiler adds no wait of
// its own.
template <typename Q, bool kMultiply>
__device__ __forceinline__ void tc_mainloop(float (&acc)[64], uint32_t xs0, uint32_t qs0,
                                            uint32_t bs0, const uint8_t* qs_ptr,
                                            uint8_t* bs_ptr, const __nv_bfloat16* __restrict__ x,
                                            const uint8_t* __restrict__ q, const Place& p, int d,
                                            int f, int steps, int wg) {
  const TcLoader ld(x, q, p, d, f);
#pragma unroll
  for (int s = 0; s < kTcStages - 2; ++s) {  // steps 0 .. kTcStages - 3: group j is step j
    if (s < steps) ld.load(xs0 + s * kXTile, qs0 + s * kQTile, s, x, q);
    cp_async_commit();
  }
  if (steps == 0) return;
  cp_async_wait<kTcStages - 3>();  // step 0 landed
  __syncthreads();
  convert_codes<Q>(qs_ptr, bs_ptr);
  fence_proxy_async();
  __syncthreads();
  // descriptors of step 0's tiles; a slot or tile further on adds its
  // offset / 16 to the address field
  const uint64_t da0 = sw128_desc(xs0 + wg * 64 * 128), db0 = sw128_desc(bs0);
  int slot = 0, bslot = 0;                   // step s's ring slot and bf16 tile
  int cslot = 1, cbslot = 1;                 // step s + 1's
  int nslot = kTcStages - 2;                 // step s + kTcStages - 2's
  for (int s = 0; s < steps; ++s) {
    if (kMultiply) {
      const uint64_t da = da0 + ((slot * kXTile) >> 4), db = db0 + ((bslot * kBTile) >> 4);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<2>();  // step s - 2's products done; s - 1's and s's in flight
    }
    cp_async_wait<kTcStages - 4>();  // step s + 1 landed
    __syncthreads();  // both halves past step s - 2; step s + 1's copies visible
    if (s + 1 < steps) {
      convert_codes<Q>(qs_ptr + cslot * kQTile, bs_ptr + cbslot * kBTile);
      fence_proxy_async();
    }
    // into the slot step s - 2 used
    if (s + kTcStages - 2 < steps)
      ld.load(xs0 + nslot * kXTile, qs0 + nslot * kQTile, s + kTcStages - 2, x, q);
    cp_async_commit();
    __syncthreads();
    slot = slot == kTcStages - 1 ? 0 : slot + 1;
    bslot = bslot == kTcB - 1 ? 0 : bslot + 1;
    cslot = cslot == kTcStages - 1 ? 0 : cslot + 1;
    cbslot = cbslot == kTcB - 1 ? 0 : cbslot + 1;
    nslot = nslot == kTcStages - 1 ? 0 : nslot + 1;
  }
}

template <typename Q>
__global__ void __launch_bounds__(kThreads, 1)
qmm_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
              const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
              float* __restrict__ ws, long long t, int d, int f, int kchunk, int splits) {
  extern __shared__ uint8_t smem[];
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const qs_ptr = smem + (base - raw) + kTcStages * kXTile;  // generic pointers
  uint8_t* const bs_ptr = qs_ptr + kTcStages * kQTile;
  const uint32_t xs0 = base, qs0 = smem_addr(qs_ptr), bs0 = smem_addr(bs_ptr);

  // row tiles run fastest: the blocks on the card at once share code tiles in L2
  const Place p = place(t, d, kchunk, kTcRows, blockIdx.x, blockIdx.y);
  const int wg = threadIdx.x >> 7;
  const int steps = p.k_end > p.k_begin ? (p.k_end - p.k_begin + kBK - 1) / kBK : 0;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // a warpgroup with no live rows (the last row tile's) multiplies nothing
  if (wg * 64 >= p.live) {
    tc_mainloop<Q, false>(acc, xs0, qs0, bs0, qs_ptr, bs_ptr, x, q, p, d, f, steps, wg);
    return;
  }
  tc_mainloop<Q, true>(acc, xs0, qs0, bs0, qs_ptr, bs_ptr, x, q, p, d, f, steps, wg);
  wgmma_wait<0>();
  fence_acc(acc);

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = p.n0 + j * 8 + (lane & 3) * 2;  // F is whole 16s: a pair is in or out
    if (col >= f) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= p.live) continue;
      const long long row = p.row0 + r;
      const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      if (splits == 1) {
        const float2 sc = *reinterpret_cast<const float2*>(scale + col);
        *reinterpret_cast<__nv_bfloat162*>(out + row * f + col) =
            __floats2bfloat162_rn(v0 * sc.x, v1 * sc.y);
      } else {
        *reinterpret_cast<float2*>(ws + (static_cast<long long>(blockIdx.z) * t + row) * f +
                                   col) = make_float2(v0, v1);
      }
    }
  }
}

// out = (the ranges' partial sums, added in range order) * scale.
template <typename T>
__global__ void qmm_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
                                  T* __restrict__ out, long long tf, int f, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= tf) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += ws[s * tf + i];
  out[i] = repro::from_float<T>(sum * scale[i % f]);
}

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// The row tile of the kernel a launch of T rows of x in T takes.
template <typename T>
int row_tile(long long t) {
  return t <= kNarrow ? kNarrow : kIsBf16<T> ? kTcRows : kRows;
}

// Lets the tensor-core kernel take its shared memory (above the 48 KB a
// launch gets unasked), once a device.
template <typename Q>
cudaError_t tc_prepare() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && ready[dev])) return err;
  err = cudaFuncSetAttribute(qmm_tc_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTcSmem);
  if (err == cudaSuccess && dev < 64) ready[dev] = true;
  return err;
}

// Blocks of the kernel T rows take that one SM holds at once.
template <typename T, typename Q>
int occupancy(long long t, int* resident) {
  if (row_tile<T>(t) == kNarrow)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, qmm_narrow_kernel<T, Q, kNarrow>, kThreads, 0));
  if constexpr (kIsBf16<T>) {
    const cudaError_t err = tc_prepare<Q>();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, qmm_tc_kernel<Q>, kThreads, kTcSmem));
  }
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, qmm_rows_kernel<T, Q>, kThreads, 0));
}

template <typename T, typename Q>
int launch(const void* x, const void* q, const float* scale, void* out, float* ws,
           long long t, int d, int f, int splits, int kchunk, cudaStream_t stream) {
  if (t == 0 || f == 0) return 0;
  const int bm = row_tile<T>(t);
  const long long row_tiles = (t + bm - 1) / bm;
  const unsigned col_tiles = static_cast<unsigned>((f + kBN - 1) / kBN);
  const bool tc = kIsBf16<T> && bm == kTcRows;  // its grid runs row tiles fastest
  if ((tc ? col_tiles : row_tiles) > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid = tc ? dim3(static_cast<unsigned>(row_tiles), col_tiles, splits)
                       : dim3(col_tiles, static_cast<unsigned>(row_tiles), splits);
  const T* xt = static_cast<const T*>(x);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  T* o = static_cast<T*>(out);
  if (bm == kNarrow) {
    qmm_narrow_kernel<T, Q, kNarrow><<<grid, kThreads, 0, stream>>>(xt, qb, scale, o, ws, t, d,
                                                                     f, kchunk, splits);
  } else if constexpr (kIsBf16<T>) {
    const cudaError_t err = tc_prepare<Q>();
    if (err != cudaSuccess) return static_cast<int>(err);
    qmm_tc_kernel<Q><<<grid, kThreads, kTcSmem, stream>>>(xt, qb, scale, o, ws, t, d, f, kchunk,
                                                          splits);
  } else {
    qmm_rows_kernel<T, Q><<<grid, kThreads, 0, stream>>>(xt, qb, scale, o, ws, t, d, f, kchunk,
                                                          splits);
  }
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tf = t * f;
    qmm_reduce_kernel<T><<<static_cast<unsigned>((tf + kThreads - 1) / kThreads), kThreads, 0,
                           stream>>>(ws, scale, o, tf, f, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy_codes(int code, long long t, int* resident) {
  switch (code) {
    case repro::kCodeInt8:
      return occupancy<T, Int8>(t, resident);
    case repro::kCodeE4M3:
      return occupancy<T, E4M3>(t, resident);
    default:
      return -1;
  }
}

template <typename T>
int launch_codes(int code, const void* x, const void* q, const float* scale, void* out,
                 float* ws, long long t, int d, int f, int splits, int kchunk,
                 cudaStream_t stream) {
  switch (code) {
    case repro::kCodeInt8:
      return launch<T, Int8>(x, q, scale, out, ws, t, d, f, splits, kchunk, stream);
    case repro::kCodeE4M3:
      return launch<T, E4M3>(x, q, scale, out, ws, t, d, f, splits, kchunk, stream);
    default:
      return -1;
  }
}

}  // namespace

// x (T, D) in `dtype`, codes (D, F) int8 (code 0) or float8_e4m3fn (code
// 1), scale (F,) float32 and out (T, F) in `dtype`, all contiguous and
// 16-byte aligned, D and F whole 16-byte vectors.  The contraction runs in
// `splits` ranges of `kchunk` (a multiple of 64) rows of the codes; with
// splits > 1, ws is a (splits, T, F) float32 workspace.  Launches on
// `stream`; returns the cudaError_t of the launches (0 = ok) or -1 for an
// unsupported dtype, code or split.
int repro_quant_matmul_launch(int dtype, int code, const void* x, const void* q,
                              const float* scale, void* out, float* ws, long long t, int d,
                              int f, int splits, int kchunk, void* stream) {
  if (splits < 1 || kchunk < kBK || kchunk % kBK || (splits > 1 && ws == nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch_codes<float>(code, x, q, scale, out, ws, t, d, f, splits, kchunk, s);
    case repro::kBFloat16:
      return launch_codes<__nv_bfloat16>(code, x, q, scale, out, ws, t, d, f, splits, kchunk,
                                         s);
    default:
      return -1;
  }
}

// For a launch of T rows on the current device: the row tile of the kernel
// it takes, the blocks of that kernel one SM holds at once (its registers
// and shared memory against the SM's) and the device's SM count.  Returns
// a cudaError_t (0 = ok) or -1 for an unsupported dtype or code.
int repro_quant_matmul_occupancy_query(int dtype, int code, long long t, int* rows,
                                       int* resident, int* sms) {
  *rows = dtype == repro::kBFloat16 ? row_tile<__nv_bfloat16>(t) : row_tile<float>(t);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dtype) {
    case repro::kFloat32:
      return occupancy_codes<float>(code, t, resident);
    case repro::kBFloat16:
      return occupancy_codes<__nv_bfloat16>(code, t, resident);
    default:
      return -1;
  }
}
