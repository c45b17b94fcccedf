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
// Bound on the H100: the codes are 1 byte a weight, so at the serving
// shapes (a decode tick: T = 4; a 128-token prefill chunk) the product
// does 2 T operations a byte read, far below the ~295 the card needs to be
// compute bound: the floor is streaming the D x F codes once.  Only a
// whole-prompt prefill (T ~ 1300) reaches the operation bound.  This
// version does plain fp32 FMAs (no mma, no TMA).
//
// Two kernels share one block shape: 256 threads, a BN = 128 column tile,
// D in BK = 64 steps, the coming steps' codes and x tile loaded into
// registers while the current step is multiplied.
//
//   * rows (T > 4): a 32-row tile; the step's codes (16-byte vectors along
//     F, coalesced) and x tile are staged in shared memory as fp32; warp w
//     owns rows 4w..4w+3, lane l columns 4l..4l+3 (16 sums a thread), as
//     moe_gmm.cu; the next step is in flight during the products.
//   * narrow (T <= 4: a decode tick of 4 slots, the LM head of one token):
//     a 4-row tile; warp w owns k rows 8w..8w+7 of every step, lane l
//     columns 4l..4l+3, all 4 rows (16 sums a thread).  Each code is used
//     by one thread only, so the codes go from device memory to that
//     thread's registers (a 32-bit word a k row; a warp reads 128
//     contiguous bytes) and are converted there, with no shared-memory
//     staging; only the small x tile goes through shared memory.  Its work
//     is streaming the codes, so two steps more are in flight.  At the end
//     the 8 warps' sums are added in shared memory in warp order.
//
// Filling the card: a decode tick's w_out (F = 5120) has 40 column tiles
// for 132 SMs.  The wrapper splits D into equal ranges (blockIdx.z), as
// many as one wave of resident blocks holds; repro_quant_matmul_occupancy
// gives it the row tile, the blocks of that kernel resident on an SM and
// the card's SM count.  Each range writes its fp32 partial sums to a
// workspace, and a second kernel adds the ranges in order and applies the
// scales.  No atomics: every output is the same fixed-order sum on every
// launch, so two launches give the same bits.
#include <cuda_fp8.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBN = 128;       // columns per tile
constexpr int kBK = 64;        // contraction step
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;      // rows per tile of the row kernel
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

__device__ __forceinline__ Place place(long long t, int d, int kchunk, int bm) {
  Place p;
  p.row0 = static_cast<long long>(blockIdx.y) * bm;
  p.live = static_cast<int>(min(static_cast<long long>(bm), t - p.row0));
  p.n0 = blockIdx.x * kBN;
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

  const Place p = place(t, d, kchunk, kRows);
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

  const Place p = place(t, d, kchunk, R);
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

// The row tile of the kernel a launch of T rows takes.
inline int row_tile(long long t) { return t <= kNarrow ? kNarrow : kRows; }

// Blocks of the kernel T rows take that one SM holds at once.
template <typename T, typename Q>
int occupancy(long long t, int* resident) {
  if (row_tile(t) == kNarrow)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, qmm_narrow_kernel<T, Q, kNarrow>, kThreads, 0));
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, qmm_rows_kernel<T, Q>, kThreads, 0));
}

template <typename T, typename Q>
int launch(const void* x, const void* q, const float* scale, void* out, float* ws,
           long long t, int d, int f, int splits, int kchunk, cudaStream_t stream) {
  if (t == 0 || f == 0) return 0;
  const int bm = row_tile(t);
  const long long row_tiles = (t + bm - 1) / bm;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>((f + kBN - 1) / kBN), static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>(splits));
  const T* xt = static_cast<const T*>(x);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  T* o = static_cast<T*>(out);
  if (bm == kNarrow)
    qmm_narrow_kernel<T, Q, kNarrow><<<grid, kThreads, 0, stream>>>(xt, qb, scale, o, ws, t, d,
                                                                     f, kchunk, splits);
  else
    qmm_rows_kernel<T, Q><<<grid, kThreads, 0, stream>>>(xt, qb, scale, o, ws, t, d, f, kchunk,
                                                          splits);
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
  *rows = row_tile(t);
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
