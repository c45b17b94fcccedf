// GQA flash attention with an online softmax, contiguous full-precision KV.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) in its contiguous, unquantized,
// unwindowed form.  On the TPU the grid's minor kv axis runs in order on
// one core and carries (m, l, acc) in VMEM scratch; on Hopper the blocks
// run in parallel in no order, so one thread block owns one
// (batch, head, q-block) and walks the key blocks itself, keeping m, l and
// acc in registers (fp32).
//
// Semantics reproduced from the Pallas kernel:
//   * head hi reads KV head hi / group;
//   * scores are masked to -1e30 where k_pos >= kv_len or, when causal,
//     k_pos > q_pos + q_start (q_start per batch row);
//   * V rows at k_row >= kv_len are loaded as 0 before p.V (the
//     out-of-bounds NaN fault the attention grid once caught);
//   * key blocks with k_start >= kv_len are skipped, and, when q_start is
//     static (whole-prompt prefill, q_start = Sk - Sq), blocks above the
//     causal diagonal too;
//   * the output is acc / max(l, 1e-30), stored in q's dtype.
//
// Layout of one block: BQ query rows of TPR threads each, 256 threads —
// 64 rows of 4 for prefill and chunks, 16 rows of 16 for decode-sized
// launches (Sq <= 16), so a decode block still has 256 threads to stream
// the cache.  A thread holds 64 / TPR of its row's scores for the current
// key tile and Dh / TPR of its row's output accumulators.  Q (pre-scaled),
// K and V tiles are loaded in 16-byte vectors and staged in shared memory
// as fp32; Q and K rows are padded by one float so the strided reads of
// the score loop hit distinct banks.  Row max and row sum reduce over the
// row's threads with shuffles, and p is broadcast from its owner by
// shuffle for the p.V product.
//
// Bound on the H100: prefill and chunked prefill at Dh = 128 do ~2 * Dh
// operations per key byte and are compute-bound once the products run on
// the tensor cores; decode (one query per row) is bound by reading the
// KV cache, B * kv_len * KV * Dh * 2 * sizeof(T) bytes.  This first
// version uses plain fp32 FMAs (no wgmma/TMA) and is far from either
// bound; decode wastes the 15 spare rows of its 16-row query block, and
// each of a GQA group's heads reads the group's K/V again.
#include "common.cuh"

namespace {

constexpr int kBK = 64;        // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

template <int DH, int BQ>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(BQ * (DH + 1) + kBK * (DH + 1) + kBK * DH) * sizeof(float);
}

// BQ query rows per block, TPR threads per row (BQ * TPR = 256 threads).
template <typename T, int DH, int BQ, int TPR>
__global__ void __launch_bounds__(BQ * TPR)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, const int* __restrict__ kv_len,
             const int* __restrict__ q_start, int sq, int sk, int h, int kv, int group,
             float scale, int causal, int static_diag) {
  constexpr int NT = BQ * TPR;
  constexpr int NS = kBK / TPR;    // scores per thread per key tile
  constexpr int ND = DH / TPR;     // output columns per thread
  constexpr int VN = repro::VecLoad<T>::N;
  extern __shared__ float smem[];
  float* q_s = smem;                         // [BQ][DH + 1]
  float* k_s = q_s + BQ * (DH + 1);          // [kBK][DH + 1]
  float* v_s = k_s + kBK * (DH + 1);         // [kBK][DH]

  const int tid = threadIdx.x;
  const int r = tid / TPR;                   // query row within the block
  const int c = tid % TPR;                   // column phase within the row
  const int base = (tid & 31) & ~(TPR - 1);  // lane of the row's first thread
  const int q0 = blockIdx.x * BQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = hi / group;
  const int kvl = kv_len[bi];
  const int qs = q_start[bi];
  const int qpos = q0 + r;

  for (int idx = tid; idx < BQ * DH / VN; idx += NT) {
    const int e = idx * VN;
    const int rr = e / DH, dd = e % DH;
    const int qrow = q0 + rr;
    float vals[VN];
    if (qrow < sq) {
      repro::VecLoad<T>::load(q + ((static_cast<long long>(bi) * sq + qrow) * h + hi) * DH + dd,
                              vals);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; ++j) q_s[rr * (DH + 1) + dd + j] = vals[j] * scale;
  }

  int kend = min(kvl, sk);
  if (causal && static_diag) kend = min(kend, q0 + (sk - sq) + BQ);
  const int nkb = kend > 0 ? (kend + kBK - 1) / kBK : 0;

  float m = kNegInf, l = 0.f;
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // Q stored / previous tile consumed
    for (int idx = tid; idx < kBK * DH / VN; idx += NT) {
      const int e = idx * VN;
      const int jj = e / DH, dd = e % DH;
      const int krow = k0 + jj;
      float kvals[VN], vvals[VN];
#pragma unroll
      for (int j = 0; j < VN; ++j) kvals[j] = vvals[j] = 0.f;
      if (krow < sk) {
        const long long off = ((static_cast<long long>(bi) * sk + krow) * kv + kvh) * DH + dd;
        repro::VecLoad<T>::load(k + off, kvals);
        if (krow < kvl) repro::VecLoad<T>::load(v + off, vvals);  // rows past kv_len stay 0
      }
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        k_s[jj * (DH + 1) + dd + j] = kvals[j];
        v_s[jj * DH + dd + j] = vvals[j];
      }
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    const float* qrow_s = q_s + r * (DH + 1);
    for (int dd = 0; dd < DH; ++dd) {
      const float qd = qrow_s[dd];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = fmaf(qd, k_s[(c + TPR * i) * (DH + 1) + dd], s[i]);
    }

    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kpos = k0 + c + TPR * i;
      bool ok = kpos < kvl && kpos < sk;
      if (causal) ok = ok && kpos <= qpos + qs;
      s[i] = ok ? s[i] : kNegInf;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] = expf(s[i] - m_new);
      psum += s[i];
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[j] *= alpha;

#pragma unroll
    for (int i = 0; i < NS; ++i) {
#pragma unroll
      for (int src = 0; src < TPR; ++src) {
        const float p = __shfl_sync(0xffffffffu, s[i], base + src);
        const float* vrow = v_s + (src + TPR * i) * DH + c;
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[j] = fmaf(p, vrow[TPR * j], acc[j]);
      }
    }
    m = m_new;
  }

  if (qpos < sq) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + ((static_cast<long long>(bi) * sq + qpos) * h + hi) * DH + c;
#pragma unroll
    for (int j = 0; j < ND; ++j) orow[TPR * j] = repro::from_float<T>(acc[j] / den);
  }
}

template <typename T, int DH, int BQ, int TPR>
int launch(const void* q, const void* k, const void* v, void* o, const int* kv_len,
           const int* q_start, int b, int sq, int sk, int h, int kv, float scale, int causal,
           int static_diag, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH, BQ>();
  auto kernel = &flash_kernel<T, DH, BQ, TPR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kernel<<<grid, BQ * TPR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), kv_len, q_start, sq, sk, h, kv, h / kv, scale, causal, static_diag);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_rows(const void* q, const void* k, const void* v, void* o, const int* kv_len,
                const int* q_start, int b, int sq, int sk, int h, int kv, float scale,
                int causal, int static_diag, cudaStream_t stream) {
  // decode-sized launches: 16 rows of 16 threads; otherwise 64 rows of 4
  if (sq <= 16)
    return launch<T, DH, 16, 16>(q, k, v, o, kv_len, q_start, b, sq, sk, h, kv, scale, causal,
                                 static_diag, stream);
  return launch<T, DH, 64, 4>(q, k, v, o, kv_len, q_start, b, sq, sk, h, kv, scale, causal,
                              static_diag, stream);
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* o, const int* kv_len,
              const int* q_start, int b, int sq, int sk, int h, int kv, float scale, int causal,
              int static_diag, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch_rows<T, 64>(q, k, v, o, kv_len, q_start, b, sq, sk, h, kv, scale, causal,
                                static_diag, stream);
    case 128:
      return launch_rows<T, 128>(q, k, v, o, kv_len, q_start, b, sq, sk, h, kv, scale, causal,
                                 static_diag, stream);
    default:
      return -1;
  }
}

}  // namespace

// q (B, Sq, H, Dh), k/v (B, Sk, KV, Dh), o (B, Sq, H, Dh), all contiguous;
// kv_len and q_start are (B,) int32 on the device; q, k, v and o are
// 16-byte aligned.  Launches on `stream`;
// returns the cudaError_t of the launch (0 = ok) or -1 for an unsupported
// dtype code or head_dim.
int repro_flash_attention_launch(int dtype, int dh, const void* q, const void* k,
                                 const void* v, void* o, const int* kv_len, const int* q_start,
                                 int b, int sq, int sk, int h, int kv, float scale, int causal,
                                 int static_diag, void* stream) {
  if (b == 0 || sq == 0 || h == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch_dh<float>(dh, q, k, v, o, kv_len, q_start, b, sq, sk, h, kv, scale, causal,
                              static_diag, s);
    case repro::kBFloat16:
      return launch_dh<__nv_bfloat16>(dh, q, k, v, o, kv_len, q_start, b, sq, sk, h, kv, scale,
                                      causal, static_diag, s);
    default:
      return -1;
  }
}
