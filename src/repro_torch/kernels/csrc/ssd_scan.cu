// Mamba-2 SSD chunked scan (arXiv:2405.21060): for batch b and head h,
//   state_t = exp(dt_t A_h) state_{t-1} + dt_t B_t x_t^T,   y_t = C_t . state_t,
// evaluated chunk by chunk in the dual form.  x (B, S, H, P), dt (B, S, H)
// fp32, A (H,) fp32, B and C (B, S, G, N) in x's dtype (head h reads group
// h / (H / G)); y (B, S, H, P) in x's dtype, the final state (B, H, N, P)
// fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel).  The TPU grid is (batch, heads, chunks) with the chunk
// axis sequential, and the (N, P) state is carried from one grid step to
// the next in VMEM scratch.  Blocks on the card run in no order, so here a
// block owns one (b, h) and a slice of kSlice columns of P (every column
// of the state evolves on its own: y[:, p] needs only state[:, p] and
// x[:, p]), and walks the chunks in a loop.  Its slice of the state stays
// in registers (and a copy in shared memory for the C . state product)
// from the first chunk to the last; the final state is written once.
//
// One chunk of Q rows (any Q <= 128 that divides S; the caller's chunk is
// kept as given, since it sets the order of the sums):
//   1. load C and B (transposed, fp32, shared memory), the x slice, dt;
//      one thread takes the inclusive cumsum of dt A in row order;
//   2. y_inter[i] = (C_i exp(cum_i)) . state       (skipped at chunk 0),
//      over N in four interleaved partial sums added in a fixed order;
//   3. scores = C B^T, a register tile of up to 8 x 8 per thread (rows
//      ty + 16 r, columns tx + 16 c); then M = scores * exp(cum_i - cum_j)
//      * dt_j below the diagonal, the mask applied before exp, written over
//      C's buffer;
//   4. y[i] = sum_{j <= i} M[i, j] x[j] + y_inter[i], stored in x's dtype;
//   5. state = state exp(cum_last) + sum_j (exp(cum_last - cum_j) dt_j B_j) x_j.
// A thread owns rows warp + 8 r (r < 16) in steps 2, 4 and 5.  Where all
// 16 are live (step 4 at Q = 128, step 5 at N = 128) the contraction runs
// in the outer loop and the rows' FMAs in the inner one, unpredicated, so
// they overlap; a shorter chunk or state keeps a loop per row (predicated
// rows cost more than the overlap gains).
// All of it is fp32, as in the reference.  Every sum runs in a fixed order
// and nothing is atomic, so two launches give the same bits.
//
// Bound on the H100: at the serve chunk (B = 1, S = Q = 128, H = 48,
// P = 64, N = 128, bf16) the call moves ~3.2 MB (x, y, the fp32 state, B,
// C, dt) and needs ~0.15 GFLOP of products (C B^T once per group, the
// causal pairs only), so its floor is the memory (~1 us); at the fp32 FMA
// rate the products alone take ~2.3 us.  This version does plain fp32 FMAs from
// shared memory (no mma, no TMA), recomputes C B^T for each slice of P
// and each head of a group, and keeps one block (167 KB of shared memory
// at Q = N = 128) on an SM: it is far from that bound.  Small chunks (the
// whole-prompt prefill runs Q = gcd(128, S), e.g. 4) make the chunk loop
// latency-bound: each chunk's loads and barriers wait on the previous one.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 32;                  // columns of P a block owns (one a lane)
constexpr int kMaxChunk = 128;
constexpr int kMaxState = 128;
constexpr int kRows = kMaxChunk / kWarps;   // rows a thread owns in steps 2, 4, 5

// The block's shared memory, in floats, for chunk q and state size n: C
// (then M) and B transposed with a padded row of ld = 16 * ceil(q / 16) + 1
// (odd: the transposing stores hit distinct banks), the x slice, the
// state slice and four rows of q.
__host__ __device__ inline int row_ld(int q) { return 16 * ((q + 15) / 16) + 1; }

__host__ __device__ inline long long smem_floats(int q, int n) {
  const long long ld = row_ld(q);
  const long long cbuf = n * ld > static_cast<long long>(q) * q ? n * ld : static_cast<long long>(q) * q;
  return cbuf + n * ld + static_cast<long long>(q + n) * kSlice + 4LL * q;
}

// Step 3 for a chunk of up to 16 R rows: C B^T into an R x R register tile
// a thread, then M over C's buffer.  Every thread of the block calls it
// with the same R.
template <int R>
__device__ __forceinline__ void scores_to_m(float* ct, const float* bt, const float* cum,
                                            const float* dts, int q, int n, int ld) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = 0.f;
  for (int k = 0; k < n; ++k) {
    float cv[R], bv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cv[r] = ct[k * ld + ty + 16 * r];
      bv[r] = bt[k * ld + tx + 16 * r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
  }
  __syncthreads();   // every read of C (steps 2 and 3) is done: M goes over it
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int j = tx + 16 * c;
      if (i < q && j < q) {
        // masked before exp: above the diagonal cum_i - cum_j > 0 may overflow
        const float decay = j <= i ? expf(cum[i] - cum[j]) : 0.f;
        ct[i * q + j] = acc[r][c] * decay * dts[j];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ bm,
                    const T* __restrict__ cm, T* __restrict__ y, float* __restrict__ state_out,
                    int s, int h, int p, int g, int n, int q) {
  extern __shared__ float smem[];
  const int ld = row_ld(q);
  const int qp = 16 * ((q + 15) / 16);   // chunk rows padded to whole 16-row tiles
  float* ct = smem;                      // C^T [n][ld], then M [q][q]
  float* bt = ct + (n * ld > q * q ? n * ld : q * q);   // B^T [n][ld]
  float* xs = bt + n * ld;               // x slice [q][kSlice]
  float* st = xs + q * kSlice;           // state slice [n][kSlice]
  float* dts = st + n * kSlice;          // dt [q]
  float* cum = dts + q;                  // inclusive cumsum of dt A [q]
  float* ecum = cum + q;                 // exp(cum) [q]
  float* wts = ecum + q;                 // exp(cum_last - cum_j) dt_j [q]

  const int p0 = blockIdx.x * kSlice;
  const int hi = blockIdx.y;
  const long long bi = blockIdx.z;
  const int gi = hi / (h / g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool col_ok = p0 + lane < p;
  const float a = A[hi];
  const long long x_row = static_cast<long long>(h) * p;    // x / y elements per position
  const long long bc_row = static_cast<long long>(g) * n;   // B / C elements per position

  float state[kRows];   // rows warp + 8 r of the state slice, column lane
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    state[r] = 0.f;
    if (warp + kWarps * r < n) st[(warp + kWarps * r) * kSlice + lane] = 0.f;
  }

  const int nc = s / q;
  for (int c = 0; c < nc; ++c) {
    const long long row0 = bi * s + static_cast<long long>(c) * q;   // first position
    // -- 1. load the chunk
    for (int idx = tid; idx < qp * n; idx += kThreads) {
      const int j = idx / n, k = idx - j * n;
      float cv = 0.f, bv = 0.f;
      if (j < q) {
        const long long off = (row0 + j) * bc_row + static_cast<long long>(gi) * n + k;
        cv = to_float(cm[off]);
        bv = to_float(bm[off]);
      }
      ct[k * ld + j] = cv;
      bt[k * ld + j] = bv;
    }
    for (int idx = tid; idx < q * kSlice; idx += kThreads) {
      const int j = idx / kSlice, col = idx - j * kSlice;
      xs[idx] = p0 + col < p ? to_float(x[(row0 + j) * x_row + static_cast<long long>(hi) * p +
                                          p0 + col])
                             : 0.f;
    }
    for (int j = tid; j < q; j += kThreads) dts[j] = dt[(row0 + j) * h + hi];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int j = 0; j < q; ++j) {
        run += dts[j] * a;
        cum[j] = run;
      }
    }
    __syncthreads();
    for (int j = tid; j < q; j += kThreads) {
      ecum[j] = expf(cum[j]);
      wts[j] = expf(cum[q - 1] - cum[j]) * dts[j];
    }
    __syncthreads();

    // -- 2. the carried state's term, over N in four interleaved partial
    //       sums added in a fixed order (a dependent chain a quarter as long)
    float yi[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = warp + kWarps * r;
      float acc = 0.f;
      if (c > 0 && i < q) {
        const float e = ecum[i];
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        int k = 0;
        for (; k + 4 <= n; k += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            part[u] = fmaf(ct[(k + u) * ld + i] * e, st[(k + u) * kSlice + lane], part[u]);
        for (; k < n; ++k) part[0] = fmaf(ct[k * ld + i] * e, st[k * kSlice + lane], part[0]);
        acc = (part[0] + part[1]) + (part[2] + part[3]);
      }
      yi[r] = acc;
    }

    // -- 3. M = C B^T * decay * dt (over C's buffer)
    switch ((q + 15) / 16) {
      case 1: scores_to_m<1>(ct, bt, cum, dts, q, n, ld); break;
      case 2: scores_to_m<2>(ct, bt, cum, dts, q, n, ld); break;
      case 3: scores_to_m<3>(ct, bt, cum, dts, q, n, ld); break;
      case 4: scores_to_m<4>(ct, bt, cum, dts, q, n, ld); break;
      case 5: scores_to_m<5>(ct, bt, cum, dts, q, n, ld); break;
      case 6: scores_to_m<6>(ct, bt, cum, dts, q, n, ld); break;
      case 7: scores_to_m<7>(ct, bt, cum, dts, q, n, ld); break;
      default: scores_to_m<8>(ct, bt, cum, dts, q, n, ld); break;
    }
    __syncthreads();

    // -- 4. y = M x + y_inter.  A full chunk walks j outside and the
    //       thread's 16 rows inside, every row live (M is zero above the
    //       diagonal), so the rows' FMAs overlap; each row still sums in
    //       index order.  A shorter chunk keeps a loop per row.
    if (q == kMaxChunk) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int j = 0; j < q; ++j) {
        const float xv = xs[j * kSlice + lane];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(ct[(warp + kWarps * r) * q + j], xv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (col_ok)
          y[(row0 + warp + kWarps * r) * x_row + static_cast<long long>(hi) * p + p0 + lane] =
              from_float<T>(acc[r] + yi[r]);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = warp + kWarps * r;
        if (i < q) {
          float acc = 0.f;
          for (int j = 0; j <= i; ++j) acc = fmaf(ct[i * q + j], xs[j * kSlice + lane], acc);
          if (col_ok)
            y[(row0 + i) * x_row + static_cast<long long>(hi) * p + p0 + lane] =
                from_float<T>(acc + yi[r]);
        }
      }
    }
    // -- 5. the state at the chunk's end (step 2 read the old one before
    //       the barrier in step 3); at N = 128 every row of the thread is
    //       live and j runs outside, as in step 4
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    if (n == kMaxState) {
      for (int j = 0; j < q; ++j) {
        const float xv = xs[j * kSlice + lane], w = wts[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = fmaf(w * bt[(warp + kWarps * r) * ld + j], xv, acc[r]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (warp + kWarps * r < n)
          for (int j = 0; j < q; ++j)
            acc[r] = fmaf(wts[j] * bt[(warp + kWarps * r) * ld + j], xs[j * kSlice + lane], acc[r]);
    }
    const float chunk_decay = ecum[q - 1];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int k = warp + kWarps * r;
      if (k < n) {
        state[r] = state[r] * chunk_decay + acc[r];
        st[k * kSlice + lane] = state[r];
      }
    }
    __syncthreads();   // the next chunk overwrites C, B, x and reads the state
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int k = warp + kWarps * r;
    if (k < n && col_ok)
      state_out[((bi * h + hi) * n + k) * p + p0 + lane] = state[r];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
           void* y, float* state, int b, int s, int h, int p, int g, int n, int q,
           cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(smem_floats(q, n)) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p + kSlice - 1) / kSlice, h, b);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), state, s, h, p, g, n, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t, or -1 for what the kernel does not take (the
// wrapper checks it first): a dtype other than fp32 / bf16, a chunk
// outside [1, 128] or not dividing S, N outside [1, 128], H % G != 0.
int repro_ssd_scan_launch(int dtype, const void* x, const float* dt, const float* a,
                          const void* bm, const void* cm, void* y, float* state, int b, int s,
                          int h, int p, int g, int n, int chunk, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || s % chunk || n < 1 || n > kMaxState || g < 1 || h % g)
    return -1;
  if (b == 0 || s == 0 || h == 0 || p == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch<float>(x, dt, a, bm, cm, y, state, b, s, h, p, g, n, chunk, st);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, state, b, s, h, p, g, n, chunk, st);
  return -1;
}
