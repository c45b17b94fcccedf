// GQA flash attention with an online softmax, over a full-precision or an
// int8 / e4m3 quantized KV cache, contiguous or paged, with an optional
// sliding window.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) in its contiguous and paged
// (block_tables), full and windowed (window), full-precision and
// quantized-KV (k_scale / v_scale) forms.  On the
// TPU the grid's minor kv axis runs in order on one core and carries
// (m, l, acc) in VMEM scratch; on Hopper the blocks run in parallel in no
// order, so one thread block owns one (batch, head, q-block) and walks the
// key blocks itself, keeping m, l and acc in registers (fp32).
//
// Semantics reproduced from the Pallas kernel:
//   * head hi reads KV head hi / group;
//   * scores are masked to -1e30 where k_pos >= kv_len or, when causal,
//     k_pos > q_pos + q_start (q_start per batch row), or, when windowed,
//     k_pos < q_pos + ws with the per-row window start
//     ws = kv_len - Sq - W + 1 (the wrapper computes the row);
//   * V rows at k_row >= kv_len are loaded as 0 before p.V (the
//     out-of-bounds NaN fault the attention grid once caught);
//   * key blocks with k_start >= kv_len are skipped, and, when q_start is
//     static (whole-prompt prefill, q_start = Sk - Sq), blocks above the
//     causal diagonal too; when windowed, blocks wholly below the q-block's
//     lowest window start (q0 + ws) are skipped, which turns a long-KV
//     decode into O(W / 64) tiles;
//   * the output is acc / max(l, 1e-30), stored in q's dtype.
//
// Paged KV: k/v are (P, page, KV, Dh) pools and logical key p of row b
// lives at pool[table[b, p / page], p % page].  The Pallas kernel resolves
// one page per grid step in its index map, so it clamps block_k to divide
// the page; here the address is translated per key row as the tile is
// loaded (a row-offset table in shared memory, built one tile ahead), so a
// 64-key tile may span pages of any size.  Masking stays in logical
// coordinates.  Unallocated entries point at the park page 0: they are
// read and masked like any row past kv_len.  Rows below the q-block's
// lowest window start are neither loaded nor multiplied (K and V stay 0),
// so the straddling tile never touches a parked or recycled page's data.
// With W >= kv_len that bound is <= 0: the windowed launch does exactly
// the unwindowed launch's loads and arithmetic, and its output is
// bit-identical.
//
// Paging and the window are template flags, so each of the four forms is
// its own instance and the contiguous, unwindowed one runs the plain
// loop: no row-offset table, no window test.
//
// Quantized KV: the K/V element type is a template parameter beside them
// (KV = T is the full-precision cache).  With KV int8 or e4m3 the tile
// loader reads 16 one-byte codes a thread, converts them to fp32 exactly
// and multiplies them by the batch row's fp32 k_scale[b] / v_scale[b]
// before staging, as the Pallas kernel upcasts its VMEM tile and
// multiplies by the scale from its meta rows; everything after the stage
// is the full-precision kernel's fp32 arithmetic.  The cache streams from
// device memory at 1 byte an element: decode's byte bound halves against
// bf16.
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
// KV cache, B * min(W, kv_len) * KV * Dh * 2 * sizeof(KV) bytes.  This
// version uses plain fp32 FMAs (no wgmma/TMA) and is far from either
// bound; decode wastes the 15 spare rows of its 16-row query block, and
// each of a GQA group's heads reads the group's K/V again.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBK = 64;        // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_len;        // (B,)
  const int* q_start;       // (B,)
  const int* block_tables;  // (B, nblocks) physical pages (paged instances)
  const int* win_start;     // (B,) window start rows (windowed instances)
  const float* k_scale;     // (B,) fp32 scales (quantized instances)
  const float* v_scale;
  int sq, sk, h, kv, group; // sk: logical key extent (nblocks * page when paged)
  int page, num_pages, nblocks;
  float scale;
  int causal, static_diag;
};

template <int DH, int BQ>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(BQ * (DH + 1) + kBK * (DH + 1) + kBK * DH) * sizeof(float);
}

// Element offset of logical key row `krow` in the page pools (KV head 0,
// column 0) through the batch row's table `tbl`, or -1 when the row is not
// to be loaded: past the logical extent, below `klo`, or mapped to a page
// outside the pool.
__device__ __forceinline__ long long paged_row(const Params& p, const int* tbl, int krow,
                                               int klo) {
  if (krow >= p.sk || krow < klo) return -1;
  const int pg = tbl[krow / p.page];
  if (pg < 0 || pg >= p.num_pages) return -1;
  return (static_cast<long long>(pg) * p.page + krow % p.page) * p.kv;
}

// BQ query rows per block, TPR threads per row (BQ * TPR = 256 threads).
// KV: the cache's element type, T or a 1-byte code (then dequantized with
// the row's scales); PAGED: k/v are page pools read through the row-offset
// table; WINDOWED: keys below q_pos + ws are masked and tiles below the
// block's lowest window start are skipped.  The bound of two blocks an SM (what the
// 64-row layout's shared memory allows) lets ptxas spend up to 128
// registers a thread; without it ptxas picks 56-92 and the 64-row chunk
// and the decode run 13% slower (PERF.md).
template <typename T, typename KV, int DH, int BQ, int TPR, bool PAGED, bool WINDOWED>
__global__ void __launch_bounds__(BQ * TPR, 2) flash_kernel(const Params p) {
  constexpr bool QUANT = !std::is_same<T, KV>::value;
  constexpr int NT = BQ * TPR;
  constexpr int NS = kBK / TPR;    // scores per thread per key tile
  constexpr int ND = DH / TPR;     // output columns per thread
  constexpr int VN = repro::VecLoad<T>::N;    // q elements a vector
  constexpr int VK = repro::VecLoad<KV>::N;   // k/v elements a vector
  static_assert(NT >= kBK, "one thread per key row builds the row-offset table");
  extern __shared__ float smem[];
  float* q_s = smem;                         // [BQ][DH + 1]
  float* k_s = q_s + BQ * (DH + 1);          // [kBK][DH + 1]
  float* v_s = k_s + kBK * (DH + 1);         // [kBK][DH]
  __shared__ long long row_off[PAGED ? kBK : 1];  // the next tile's pool rows (paged_row)

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const KV* __restrict__ k = static_cast<const KV*>(p.k);
  const KV* __restrict__ v = static_cast<const KV*>(p.v);
  const int sq = p.sq, sk = p.sk, h = p.h;
  const int tid = threadIdx.x;
  const int r = tid / TPR;                   // query row within the block
  const int c = tid % TPR;                   // column phase within the row
  const int base = (tid & 31) & ~(TPR - 1);  // lane of the row's first thread
  const int q0 = blockIdx.x * BQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = hi / p.group;
  const int kvl = p.kv_len[bi];
  const int qs = p.q_start[bi];
  const int qpos = q0 + r;
  const int ws = WINDOWED ? p.win_start[bi] : 0;
  // keys below the block's lowest window start are dead for all its rows
  const int klo = WINDOWED ? q0 + ws : 0;
  const int* tbl = PAGED ? p.block_tables + static_cast<long long>(bi) * p.nblocks : nullptr;
  float ksc = 1.f, vsc = 1.f;
  if constexpr (QUANT) {
    ksc = p.k_scale[bi];
    vsc = p.v_scale[bi];
  }

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
    for (int j = 0; j < VN; ++j) q_s[rr * (DH + 1) + dd + j] = vals[j] * p.scale;
  }

  int kend = min(kvl, sk);
  if (p.causal && p.static_diag) kend = min(kend, q0 + (sk - sq) + BQ);
  const int nkb = kend > 0 ? (kend + kBK - 1) / kBK : 0;
  const int kb0 = klo > 0 ? klo / kBK : 0;   // first tile holding a live key

  if constexpr (PAGED) {
    if (tid < kBK) row_off[tid] = paged_row(p, tbl, kb0 * kBK + tid, klo);
  }

  float m = kNegInf, l = 0.f;
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;

  for (int kb = kb0; kb < nkb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // Q and row offsets stored / previous tile consumed
    for (int idx = tid; idx < kBK * DH / VK; idx += NT) {
      const int e = idx * VK;
      const int jj = e / DH, dd = e % DH;
      const int krow = k0 + jj;
      float kvals[VK], vvals[VK];
#pragma unroll
      for (int j = 0; j < VK; ++j) kvals[j] = vvals[j] = 0.f;
      long long ro;
      bool live;
      if constexpr (PAGED) {
        ro = row_off[jj];
        live = ro >= 0;
      } else {
        ro = (static_cast<long long>(bi) * sk + krow) * p.kv;
        live = krow < sk && (!WINDOWED || krow >= klo);
      }
      if (live) {
        const long long off = (ro + kvh) * DH + dd;
        repro::VecLoad<KV>::load(k + off, kvals);
        if (krow < kvl) repro::VecLoad<KV>::load(v + off, vvals);  // rows past kv_len stay 0
      }
#pragma unroll
      for (int j = 0; j < VK; ++j) {
        // the dequantization: code (exact in fp32) times the row's scale
        k_s[jj * (DH + 1) + dd + j] = QUANT ? kvals[j] * ksc : kvals[j];
        v_s[jj * DH + dd + j] = QUANT ? vvals[j] * vsc : vvals[j];
      }
    }
    __syncthreads();
    if constexpr (PAGED) {
      // the next tile's row offsets: row_off is not read again before the
      // barrier at the top of the next iteration
      if (tid < kBK) row_off[tid] = paged_row(p, tbl, k0 + kBK + tid, klo);
    }

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
      if (p.causal) ok = ok && kpos <= qpos + qs;
      if constexpr (WINDOWED) ok = ok && kpos >= qpos + ws;
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
        const float pr = __shfl_sync(0xffffffffu, s[i], base + src);
        const float* vrow = v_s + (src + TPR * i) * DH + c;
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[j] = fmaf(pr, vrow[TPR * j], acc[j]);
      }
    }
    m = m_new;
  }

  if (qpos < sq) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = static_cast<T*>(p.o) + ((static_cast<long long>(bi) * sq + qpos) * h + hi) * DH + c;
#pragma unroll
    for (int j = 0; j < ND; ++j) orow[TPR * j] = repro::from_float<T>(acc[j] / den);
  }
}

template <typename T, typename KV, int DH, int BQ, int TPR, bool PAGED, bool WINDOWED>
int launch(const Params& p, int b, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH, BQ>();
  auto kernel = &flash_kernel<T, KV, DH, BQ, TPR, PAGED, WINDOWED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, b);
  kernel<<<grid, BQ * TPR, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV, int DH, int BQ, int TPR>
int launch_form(const Params& p, int b, cudaStream_t stream) {
  const bool paged = p.block_tables != nullptr, windowed = p.win_start != nullptr;
  if (paged && windowed) return launch<T, KV, DH, BQ, TPR, true, true>(p, b, stream);
  if (paged) return launch<T, KV, DH, BQ, TPR, true, false>(p, b, stream);
  if (windowed) return launch<T, KV, DH, BQ, TPR, false, true>(p, b, stream);
  return launch<T, KV, DH, BQ, TPR, false, false>(p, b, stream);
}

template <typename T, typename KV, int DH>
int launch_rows(const Params& p, int b, cudaStream_t stream) {
  // decode-sized launches: 16 rows of 16 threads; otherwise 64 rows of 4
  if (p.sq <= 16) return launch_form<T, KV, DH, 16, 16>(p, b, stream);
  return launch_form<T, KV, DH, 64, 4>(p, b, stream);
}

template <typename T, typename KV>
int launch_dh(int dh, const Params& p, int b, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch_rows<T, KV, 64>(p, b, stream);
    case 128:
      return launch_rows<T, KV, 128>(p, b, stream);
    default:
      return -1;
  }
}

// The cache's element type: q's own without scales, else the code format.
template <typename T>
int launch_kv(int code, int dh, const Params& p, int b, cudaStream_t stream) {
  if (p.k_scale == nullptr) return launch_dh<T, T>(dh, p, b, stream);
  switch (code) {
    case repro::kCodeInt8:
      return launch_dh<T, int8_t>(dh, p, b, stream);
    case repro::kCodeE4M3:
      return launch_dh<T, __nv_fp8_e4m3>(dh, p, b, stream);
    default:
      return -1;
  }
}

}  // namespace

// q (B, Sq, H, Dh) and o (B, Sq, H, Dh) contiguous; k/v contiguous, either
// (B, Sk, KV, Dh) with block_tables null, or paged pools (P, page, KV, Dh)
// with block_tables a (B, nblocks) int32 table on the device and
// Sk = nblocks * page the logical extent.  k/v are of q's dtype with
// k_scale and v_scale null, or 1-byte codes of format `code` (int8 0,
// e4m3 1) with k_scale and v_scale (B,) float32 on the device.  kv_len,
// q_start and (when not null) win_start are (B,) int32 on the device; q,
// k, v and o are 16-byte aligned.  Launches on `stream`; returns the
// cudaError_t of the launch (0 = ok) or -1 for an unsupported dtype, code
// format or head_dim.
int repro_flash_attention_launch(int dtype, int code, int dh, const void* q, const void* k,
                                 const void* v, void* o, const int* kv_len, const int* q_start,
                                 const int* block_tables, int nblocks, int page, int num_pages,
                                 const int* win_start, const float* k_scale,
                                 const float* v_scale, int b, int sq, int sk, int h, int kv,
                                 float scale, int causal, int static_diag, void* stream) {
  if (b == 0 || sq == 0 || h == 0) return 0;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return -1;
  const Params p{q,       k,       v,  o,  kv_len, q_start, block_tables, win_start,
                 k_scale, v_scale, sq, sk, h,      kv,      h / kv,       page,
                 num_pages, nblocks, scale, causal, static_diag};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch_kv<float>(code, dh, p, b, s);
    case repro::kBFloat16:
      return launch_kv<__nv_bfloat16>(code, dh, p, b, s);
    default:
      return -1;
  }
}
