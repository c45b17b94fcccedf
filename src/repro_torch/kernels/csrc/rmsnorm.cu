// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * w, one row of x per block.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel), which tiles rows into VMEM with the whole feature
// dimension resident.  Here one thread block owns one row: its threads
// stride over the row in 16-byte loads, reduce the fp32 sum of squares
// with warp shuffles and one shared-memory step, then scale and store.
// Math is fp32, the store is in x's dtype, as in the Pallas kernel.
//
// Bound on the H100: bytes.  The kernel reads x once (plus the weight,
// which stays in L2) and writes y once, about 4 operations per element,
// far below the card's ~20 float32 operations per byte, so its floor is
// (2 * rows * d + d) * sizeof(T) over the memory rate.  The second pass
// re-reads the row from L1/L2 (a 10 KB bf16 row), not from memory.  At the
// serving shapes (4 to 128 rows) the launch, not the bytes, is the cost.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// d must be a multiple of VecLoad<T>::N and x, w, y 16-byte aligned (the
// wrapper checks both).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               int d, float eps) {
  constexpr int N = repro::VecLoad<T>::N;
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x * N; i < d; i += kThreads * N) {
    float v[N];
    repro::VecLoad<T>::load(xr + i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) ss += v[j] * v[j];
  }
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) inv_rms = rsqrtf(v / static_cast<float>(d) + eps);
  }
  __syncthreads();

  const float r = inv_rms;
  for (int i = threadIdx.x * N; i < d; i += kThreads * N) {
    float v[N], g[N];
    repro::VecLoad<T>::load(xr + i, v);
    repro::VecLoad<T>::load(w + i, g);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = (v[j] * r) * g[j];
    repro::VecStore<T>::store(yr + i, v);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, long long rows, int d, float eps,
           cudaStream_t stream) {
  if (rows == 0) return 0;
  rmsnorm_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok) or
// -1 for an unsupported dtype code.
int repro_rmsnorm_launch(int dtype, const void* x, const void* w, void* y,
                         long long rows, int d, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(x, w, y, rows, d, eps, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(x, w, y, rows, d, eps, s);
    default:
      return -1;
  }
}
