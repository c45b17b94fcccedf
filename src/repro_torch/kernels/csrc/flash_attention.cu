// GQA flash attention with an online softmax, over a full-precision or an
// int8 / e4m3 quantized KV cache, contiguous or paged, with an optional
// sliding window.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) in its contiguous and paged
// (block_tables), full and windowed (window), full-precision and
// quantized-KV (k_scale / v_scale) forms.  On the TPU the grid's minor kv
// axis runs in order on one core and carries (m, l, acc) in VMEM scratch;
// on Hopper the blocks run in parallel in no order, so one thread block
// owns one (batch, head, q-block) and walks the key tiles itself, keeping
// m, l and acc in registers (fp32).
//
// Semantics reproduced from the Pallas kernel, by every kernel below:
//   * head hi reads KV head hi / group;
//   * scores are masked to -1e30 where k_pos >= kv_len or, when causal,
//     k_pos > q_pos + q_start (q_start per batch row), or, when windowed,
//     k_pos < q_pos + ws with the per-row window start
//     ws = kv_len - Sq - W + 1 (the wrapper computes the row);
//   * V rows at k_row >= kv_len are loaded as 0 before p.V (the
//     out-of-bounds NaN fault the attention grid once caught);
//   * key tiles with k_start >= kv_len are skipped, and, when q_start is
//     static (whole-prompt prefill, q_start = Sk - Sq), tiles above the
//     causal diagonal too; when windowed, tiles wholly below the q-block's
//     lowest window start (q0 + ws) are skipped, which turns a long-KV
//     decode into O(W / 64) tiles;
//   * the output is acc / max(l, 1e-30), stored in q's dtype.
//
// Paged KV: k/v are (P, page, KV, Dh) pools and logical key p of row b
// lives at pool[table[b, p / page], p % page].  The Pallas kernel resolves
// one page per grid step in its index map, so it clamps block_k to divide
// the page; here the address is translated per key row as the tile is
// copied (from a row table in shared memory, built ahead of the copies),
// so a 64-key tile may span pages of any size.  Masking stays in logical coordinates.
// Unallocated entries point at the park page 0: they are read and masked
// like any row past kv_len.  Rows below the q-block's lowest window start
// are neither loaded nor multiplied (K and V stay 0), so the straddling
// tile never touches a parked or recycled page's data.  With W >= kv_len
// that bound is <= 0: the windowed launch does exactly the unwindowed
// launch's loads and arithmetic, and its output is bit-identical.
//
// Quantized KV: the K/V element type is a template parameter (KV = T is
// the full-precision cache; int8 or e4m3 codes with one fp32 k_scale[b] /
// v_scale[b] a batch row).  The cache streams from device memory at 1 byte
// an element.
//
// Three kernels, chosen by q's dtype and Sq (launch_rows, the one place
// the rule lives); the entry point reports which one each launch took, and
// the Python wrapper counts launches by it.  Each has an instance per K/V
// type and head width (64, 128).  flash_tc_kernel and flash_kernel have
// one per form: paging and the window are template flags, so the
// contiguous, unwindowed instance runs the plain loop (no page lookup, no
// window test); flash_decode_kernel one per layout, the window read at
// run time (it only moves the first live key).
//
//   * flash_tc_kernel: bf16 q with Sq > 16 (whole-prompt prefill, every
//     chunked-prefill step, windowed_attention).  These do ~2 Dh = 256
//     operations a key byte at Dh = 128, times the rows of a q-block, far
//     above the ~295 a byte of device memory at which the card's bf16
//     tensor cores become the limit: they are bound by the tensor cores
//     (989 TFLOP/s), and the products run there.  mma.sync.m16n8k16 on
//     bf16 with fp32 accumulators, not wgmma: its S accumulator fragment
//     is, element for element, the A fragment of P.V, so P stays in
//     registers with no trip through shared memory, and it needs no
//     descriptors.  Four warps of 16 query rows make a 64-row block of
//     128 threads; Q is copied once as bf16 (not pre-scaled) and held in
//     registers as A fragments; K fragments come by ldmatrix from the K
//     tile, V fragments by ldmatrix.trans from the V tile.
//     Why this is the Pallas kernel's function: it upcasts q, k and v to
//     fp32 and contracts with fp32 sums.  A product of two bf16 values is
//     exact in fp32, so S = q.k on the tensor cores differs only in the
//     order of its fp32 sums, and the softmax scale (times k_scale[b])
//     multiplies the fp32 S after the product.  Every int8 code and every
//     finite e4m3 value is exact in bf16 and the scale is one fp32 scalar
//     a batch row, so k_scale[b] folds into the score scale and v_scale[b]
//     multiplies the finished acc / l.  The one rounding the Pallas kernel
//     does not make is p to bf16 for P.V (2^-9 of each weight, the size of
//     the bf16 output's own rounding); l sums the fp32 p.  The scale
//     carries log2(e), so the exponentials are exp2.
//     K and V tiles (64 keys) come through a ring of 3 stages filled by
//     16-byte cp.async, zero-filled where a row is not to be loaded, so
//     the next two tiles' copies are in flight while one is multiplied;
//     one barrier a tile.  Rows are stored with their 16-byte chunks
//     swizzled (chunk c of row r at c ^ (r % 8)): the 8 rows an ldmatrix
//     reads hit 8 distinct bank groups.  A 1-byte cache is copied as 1
//     byte, and each code tile is decoded once in shared memory into a
//     bf16 tile with common.cuh's exact pair decoders (bit operations and
//     one bf16x2 FMA a pair).  A paged launch's row table is built
//     three tiles ahead by 64 threads, one table entry each, read at
//     the top of an iteration and stored at its end, so the lookup's
//     latency hides behind the products.  Tiles the whole block sees
//     unmasked skip the mask test.  The q-blocks with the most tiles (the causal
//     prefill's last rows) are started first.  No atomics and no split of
//     the key loop: two launches give the same bits, the paged instance
//     differs from the contiguous one only in the addresses it copies
//     from, and W >= kv_len is the unwindowed launch bit for bit.
//     Filling the card: a whole 2048-token prompt at H = 40 is 1280
//     blocks, two resident an SM (112 KB of shared memory at Dh = 128);
//     a 128-token chunk is 80 blocks for 132 SMs, one an SM.
//   * flash_decode_kernel + flash_decode_combine: bf16 q with Sq = 1 (every
//     decode_attention launch; also a causal launch of one row, a 1-token
//     prompt or a 1-row chunk, whose one query sees keys below
//     min(kv_len, q_start + 1)).  Decode reads the cache once, B *
//     min(W, kv_len) * KV * Dh * 2 * sizeof(KV) bytes, and does 4 Dh
//     operations a key row and head, ~5 a byte for qwen's group of 5 and
//     ~1 at MHA-16: far below the tensor cores' ridge (~295 a byte), so
//     the bound is bytes, and the design reads every byte once with its
//     copies in flight.
//     GQA packing: a block owns one (batch row, KV head, split of keys)
//     and the query heads of that KV head's group as the rows of one m16
//     tile (every head of qwen's 5, the rest of the 16 rows zero; groups
//     above 16 take one block per 16 heads), so each K/V row is read once
//     for the group.
//     Split-KV: a split is 128 logical keys, two 64-key tiles, 128 threads.
//     128 and not 256: qwen's serve decode (B = 4, pos 100/700/1600/2047)
//     has 288 live blocks of 512, over 2 an SM, where 256 would give 152
//     for 132 SMs.  The split boundaries are logical positions,
//     independent of kv_len, the page size and the card, and their number
//     depends on the static Sk alone: the grid reads nothing from the
//     device (capturable in a CUDA graph), and a paged launch does the
//     contiguous launch's arithmetic on the same keys.  A split wholly at
//     or past kv_len (or the causal limit), or wholly below the window
//     start, loads nothing and writes m = -1e30, l = 0.
//     Copies: q and the split's K (copy group 0) and V (group 1) are all
//     issued at the block's start as 16-byte cp.async, 64 KB in flight a
//     block for bf16 at Dh = 128 and three blocks an SM: a buffer of four
//     64-row stages that never wraps, since a split is the block's whole
//     work; V lands while S is computed.  Rows not live (past kv_len or
//     the causal limit, below the window start, on a page outside the
//     pool) are zero-filled and not read, so the park page's poison never
//     reaches a sum.  Paged launches translate each key's pool row once
//     into a shared row table before the copies.  A 1-byte cache is
//     copied as 1 byte and decoded exactly, K and then V, into one bf16
//     tile with common.cuh's pair decoders (decode_tile); k_scale[b]
//     folds into the score scale and v_scale[b] multiplies the finished
//     output.
//     Arithmetic: mma.sync, as flash_tc_kernel's.  Bytes bound a decode
//     across the card, but a block does its arithmetic after its bytes
//     land, with three blocks an SM to hide it: the fp32-FMA form of this
//     kernel spent most of a block's time in its score and p.V loops
//     (0.0311 ms for qwen's decode row on an H100, against 0.0055 ms for
//     its bytes; PERF.md).  Each warp takes S = q K^T for 32 of the split's keys
//     (exact bf16 products, fp32 sums), scaled by scale * k_scale *
//     log2(e) and masked to -1e30; each row's max over the split reduces
//     by shuffles and then across the warps in warp order; p = exp2(s -
//     m) and its sum l stay fp32; p is rounded to bf16 for P.V, the one
//     rounding the Pallas kernel does not make (2^-9 of each weight, the
//     size of the bf16 output's own rounding), as in flash_tc_kernel;
//     each warp then takes a quarter of the Dh output columns over all
//     128 keys, reading p from shared memory.  The block writes each
//     head's (m, l, acc[Dh]) of the split to a float32 workspace of B * H
//     * splits * (Dh + 2) floats, which the wrapper allocates (the kernel
//     allocates nothing) at the size repro_flash_attention_workspace_query
//     gives: the rule has one owner.  The workspace pointer is a kernel
//     argument of its own, so Params, which the other kernels take, is
//     unchanged.
//     Combine: a second kernel reads each (b, h)'s splits in split order
//     0, 1, ..., n - 1 and writes sum(w acc) / max(sum(w l), 1e-30) with
//     w = exp2(m_split - m), times v_scale[b], as bf16.  An empty split's
//     weight is exp2(-1e30 - m) = 0: it is skipped, which adds exactly
//     what its 0 would.  No atomics: two launches give the same bits, the
//     paged launch the contiguous one's, and W >= kv_len (window start <=
//     0) the unwindowed one's.  Both kernels count as one launch of the
//     op.
//   * flash_kernel: fp32 q (the tests, the fp32 model phase), and bf16 q
//     with 2-16 rows (no serve run takes it: chunks are padded to 128).  BQ
//     query rows of TPR threads each, 256 threads — 64 rows of 4 for more
//     than 16 rows, 16 rows of 16 for 16 or fewer, so a decode-sized
//     block still has 256 threads to stream the cache.  A thread holds 64 /
//     TPR of its row's scores for the current key tile and Dh / TPR of its
//     row's output accumulators.  Q (pre-scaled), K and V tiles are
//     loaded in 16-byte vectors and staged in shared memory as fp32 (a
//     1-byte code converted exactly and multiplied by its row's scale, as
//     the Pallas kernel upcasts its VMEM tile); Q and K rows are padded by
//     one float so the strided reads of the score loop hit distinct banks.
//     Row max and row sum reduce over the row's threads with shuffles, and
//     p is broadcast from its owner by shuffle for the p.V product.  fp32
//     q stays on fp32 FMAs: TF32 keeps ~10 bits of q, outside fp32's
//     tolerance, and no bf16 serve run takes it.  An fp32 decode wastes
//     the 15 spare rows of its 16-row block, and each of a GQA group's
//     heads reads the group's K/V again.
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

// --------------------------------------------------------------------------
// The tensor-core kernel: bf16 q, Sq > 16
// --------------------------------------------------------------------------
constexpr int kTcRows = 64;      // query rows a block: 4 warps of 16
constexpr int kTcThreads = 128;
constexpr int kTcStages = 3;     // the K/V ring
constexpr float kLog2e = 1.4426950408889634f;

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;
using repro::smem_addr;
using repro::swz;

// Two codes (the low bytes of t's 16-bit halves) to a bf16 pair, exactly.
template <typename KV>
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t t);

template <>
__device__ __forceinline__ uint32_t codes_to_bf16x2<int8_t>(uint32_t t) {
  return repro::int8x2_to_bf16x2(t);
}

template <>
__device__ __forceinline__ uint32_t codes_to_bf16x2<__nv_fp8_e4m3>(uint32_t t) {
  return repro::e4m3x2_to_bf16x2(t);
}

// Decodes a staged tile of 1-byte codes (kBK rows of DH codes, row-major)
// into the bf16 tile the products read (rows of DH / 8 swizzled chunks).
// A warp reads 512 consecutive bytes.
template <typename KV, int DH>
__device__ __forceinline__ void decode_tile(const uint8_t* codes, uint8_t* out) {
  constexpr int CPR = DH / 16;  // 16-code chunks a row
  static_assert(kBK * CPR % kTcThreads == 0, "whole passes");
#pragma unroll
  for (int j = 0; j < kBK * CPR / kTcThreads; ++j) {
    const int idx = threadIdx.x + j * kTcThreads;
    const int r = idx / CPR, c = idx % CPR;
    const uint4 u = *reinterpret_cast<const uint4*>(codes + idx * 16);
    uint4 lo, hi;  // codes 0..7 and 8..15 of the chunk
    lo.x = codes_to_bf16x2<KV>(__byte_perm(u.x, 0, 0x4140));
    lo.y = codes_to_bf16x2<KV>(__byte_perm(u.x, 0, 0x4342));
    lo.z = codes_to_bf16x2<KV>(__byte_perm(u.y, 0, 0x4140));
    lo.w = codes_to_bf16x2<KV>(__byte_perm(u.y, 0, 0x4342));
    hi.x = codes_to_bf16x2<KV>(__byte_perm(u.z, 0, 0x4140));
    hi.y = codes_to_bf16x2<KV>(__byte_perm(u.z, 0, 0x4342));
    hi.z = codes_to_bf16x2<KV>(__byte_perm(u.w, 0, 0x4140));
    hi.w = codes_to_bf16x2<KV>(__byte_perm(u.w, 0, 0x4342));
    *reinterpret_cast<uint4*>(out + swz(r, 2 * c, DH / 8)) = lo;
    *reinterpret_cast<uint4*>(out + swz(r, 2 * c + 1, DH / 8)) = hi;
  }
}

template <typename KV, int DH>
constexpr size_t tc_smem_bytes() {
  // Q, the ring of K and V tiles, and for a 1-byte cache the decoded tiles
  return static_cast<size_t>(kTcRows * DH * 2 + kTcStages * 2 * kBK * DH * sizeof(KV) +
                             (sizeof(KV) == 1 ? 2 * kBK * DH * 2 : 0));
}

// bf16 q; KV: bf16 or a 1-byte code; PAGED / WINDOWED as flash_kernel's.
// Grid (H, q-blocks, B); 128 threads, two blocks an SM.
template <typename KV, int DH, bool PAGED, bool WINDOWED>
__global__ void __launch_bounds__(kTcThreads, 2) flash_tc_kernel(const Params p) {
  using T = __nv_bfloat16;
  constexpr bool QUANT = !std::is_same<T, KV>::value;
  constexpr int ES = static_cast<int>(sizeof(KV));
  constexpr int CPR = DH * ES / 16;        // 16-byte chunks a ring row
  constexpr int RPP = kTcThreads / CPR;    // ring rows a pass of the block's copies
  constexpr int PASSES = kBK / RPP;        // passes a tile
  constexpr int BCPR = DH / 8;             // 16-byte chunks a bf16 row
  constexpr int KV_TILE = kBK * DH * ES;   // bytes of a ring tile (K or V)
  constexpr int BF_TILE = kBK * DH * 2;    // bytes of a bf16 tile
  constexpr int NK = kBK / 8;              // score fragments (8 keys each) a row group
  constexpr int ND = DH / 8;               // output fragments (8 columns each)
  static_assert(BCPR % 8 == 0 && kTcThreads % CPR == 0 && kBK % RPP == 0, "tile maps");
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const uint32_t q_s = smem_addr(tc_smem);
  const uint32_t ring = q_s + kTcRows * DH * 2;
  const uint32_t bf = ring + kTcStages * 2 * KV_TILE;  // decoded K, then V (1-byte cache)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hi = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // the longest q-blocks first
  const int bi = blockIdx.z;
  const int sq = p.sq, sk = p.sk;
  const int kvh = hi / p.group;
  const int kvl = p.kv_len[bi];
  const int klim = min(kvl, sk);
  const int qs = p.q_start[bi];
  const int ws = WINDOWED ? p.win_start[bi] : 0;
  const int klo = WINDOWED ? q0 + ws : 0;  // below it keys are dead for every row
  const int* tbl = PAGED ? p.block_tables + static_cast<long long>(bi) * p.nblocks : nullptr;
  float sc = p.scale * kLog2e, vsc = 1.f;
  if constexpr (QUANT) {
    sc = p.scale * p.k_scale[bi] * kLog2e;
    vsc = p.v_scale[bi];
  }

  int kend = klim;
  if (p.causal && p.static_diag) kend = min(kend, q0 + (sk - sq) + kTcRows);
  const int kb0 = klo > 0 ? klo / kBK : 0;  // first tile holding a live key
  const int nt = max((kend > 0 ? (kend + kBK - 1) / kBK : 0) - kb0, 0);

  // Paged: the pool token row (page * page size + offset) of each key row
  // of a tile, -1 where the row is not to be loaded (paged_row's test), in
  // the slot of the tile's ring stage.  Key row tid of the tile three
  // ahead is looked up by thread tid < kBK: its table entry is read at the
  // top of an iteration and its row stored at the end, after the products.
  __shared__ int tok_row[PAGED ? kTcStages : 1][PAGED ? kBK : 1];
  auto tok_of = [&](int krow, int pg) {
    return pg >= 0 && pg < p.num_pages ? pg * p.page + krow % p.page : -1;
  };
  auto page_of = [&](int krow) { return krow < sk && krow >= klo ? tbl[krow / p.page] : -1; };

  // The block's copies: thread tid takes chunk tid % CPR of ring rows
  // tid / CPR + RPP j.
  const KV* __restrict__ kg = static_cast<const KV*>(p.k);
  const KV* __restrict__ vg = static_cast<const KV*>(p.v);
  const int crow = tid / CPR, cchunk = tid % CPR;
  auto copy_tile = [&](int kb, int stage) {
    const uint32_t kdst = ring + stage * 2 * KV_TILE, vdst = kdst + KV_TILE;
#pragma unroll
    for (int j = 0; j < PASSES; ++j) {
      const int jj = crow + RPP * j;
      const int krow = kb * kBK + jj;
      long long ro;
      bool live;
      if constexpr (PAGED) {
        const int tok = tok_row[stage][jj];
        live = tok >= 0;
        ro = static_cast<long long>(tok) * p.kv;
      } else {
        live = krow < sk && (!WINDOWED || krow >= klo);
        ro = (static_cast<long long>(bi) * sk + krow) * p.kv;
      }
      const long long off = live ? (ro + kvh) * DH + cchunk * (16 / ES) : 0;
      const uint32_t dst = QUANT ? static_cast<uint32_t>((jj * CPR + cchunk) * 16)
                                 : swz(jj, cchunk, CPR);
      cp_async16(kdst + dst, kg + off, live);
      cp_async16(vdst + dst, vg + off, live && krow < kvl);  // rows past kv_len stay 0
    }
  };

  // group 0: Q and tile 0; group s: tile s
  const T* __restrict__ qg = static_cast<const T*>(p.q);
#pragma unroll
  for (int j = 0; j < kTcRows * BCPR / kTcThreads; ++j) {
    const int r = tid / BCPR + j * (kTcThreads / BCPR), c = tid % BCPR;
    const bool ok = q0 + r < sq;
    const long long row = static_cast<long long>(bi) * sq + (ok ? q0 + r : 0);
    cp_async16(q_s + swz(r, c, BCPR), qg + (row * p.h + hi) * DH + c * 8, ok);
  }
  if constexpr (PAGED) {
    if (tid < kBK) {
#pragma unroll
      for (int s = 0; s < kTcStages; ++s) {
        const int krow = (kb0 + s) * kBK + tid;
        tok_row[s][tid] = tok_of(krow, page_of(krow));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nt) copy_tile(kb0 + s, s);
    cp_async_commit();
  }

  uint32_t qf[DH / 16][4];
  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g and g + 8 of the warp
  const int qrow0 = q0 + warp * 16 + g;
  int stage = 0;  // tile i's ring stage

  for (int i = 0; i < nt; ++i) {
    const int k0 = (kb0 + i) * kBK;
    cp_async_wait<kTcStages - 2>();  // tile i landed (and Q with tile 0)
    __syncthreads();                 // ... for every thread; tile i - 1 consumed
    const int next = i + kTcStages - 1;  // into the stage tile i - 1 used
    if (next < nt) copy_tile(kb0 + next, stage == 0 ? kTcStages - 1 : stage - 1);
    cp_async_commit();
    int ahead_row = 0, ahead_page = -1;  // paged: key row tid of tile i + 3
    if constexpr (PAGED) {
      if (tid < kBK) {
        ahead_row = k0 + kTcStages * kBK + tid;
        ahead_page = page_of(ahead_row);
      }
    }
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldsm_x4(qf[kk], q_s + swz(warp * 16 + (lane & 15), 2 * kk + (lane >> 4), BCPR));
    }
    uint32_t ks = ring + stage * 2 * KV_TILE, vs = ks + KV_TILE;
    if constexpr (QUANT) {
      decode_tile<KV, DH>(tc_smem + (ks - q_s), tc_smem + (bf - q_s));
      decode_tile<KV, DH>(tc_smem + (vs - q_s), tc_smem + (bf + BF_TILE - q_s));
      __syncthreads();
      ks = bf;
      vs = bf + BF_TILE;
    }

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NK / 2; ++n2) {
        uint32_t b[4];
        ldsm_x4(b, ks + swz(n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                            2 * kk + ((lane >> 3) & 1), BCPR));
        mma_bf16(s[2 * n2], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale (log2 units) and mask; a tile every row of the block sees whole
    // (below kv_len, the diagonal and above every window start) is not tested
    const bool whole = k0 + kBK <= klim && (!p.causal || k0 + kBK - 1 <= q0 + qs) &&
                       (!WINDOWED || k0 >= q0 + kTcRows - 1 + ws);
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sc;
        if (!whole) {
          const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
          const int qpos = qrow0 + (e >> 1) * 8;
          bool ok = kpos < klim;
          if (p.causal) ok = ok && kpos <= qpos + qs;
          if constexpr (WINDOWED) ok = ok && kpos >= qpos + ws;
          x = ok ? x : kNegInf;
        }
        s[n][e] = x;
      }
    }

    // online softmax over the tile; a row's 4 lanes reduce by shuffles
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];  // this lane's part of the row sum, reduced at the end
      }
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

    // O += P V, P (bf16) from the score fragments of keys 16 kv .. 16 kv + 15
#pragma unroll
    for (int kv = 0; kv < kBK / 16; ++kv) {
      const uint32_t a[4] = {pack_bf16(s[2 * kv][0], s[2 * kv][1]),
                             pack_bf16(s[2 * kv][2], s[2 * kv][3]),
                             pack_bf16(s[2 * kv + 1][0], s[2 * kv + 1][1]),
                             pack_bf16(s[2 * kv + 1][2], s[2 * kv + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + swz(kv * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                  2 * d2 + (lane >> 4), BCPR));
        mma_bf16(o[2 * d2], a, b[0], b[1]);
        mma_bf16(o[2 * d2 + 1], a, b[2], b[3]);
      }
    }
    if constexpr (PAGED) {
      // into tile i's slot: tile i + 3 takes its ring stage
      if (tid < kBK) tok_row[stage][tid] = tok_of(ahead_row, ahead_page);
    }
    stage = stage == kTcStages - 1 ? 0 : stage + 1;
  }
  cp_async_wait<0>();  // no copy in flight at exit

  T* __restrict__ og = static_cast<T*>(p.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qrow = qrow0 + 8 * r;
    if (qrow < sq) {
      const float den = fmaxf(l[r], 1e-30f);
      T* orow = og + ((static_cast<long long>(bi) * sq + qrow) * p.h + hi) * DH + 2 * t4;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        float x0 = o[d][2 * r] / den, x1 = o[d][2 * r + 1] / den;
        if constexpr (QUANT) {
          x0 *= vsc;
          x1 *= vsc;
        }
        *reinterpret_cast<uint32_t*>(orow + 8 * d) = pack_bf16(x0, x1);
      }
    }
  }
}

// --------------------------------------------------------------------------
// The split-KV decode kernel: bf16 q, Sq = 1
// --------------------------------------------------------------------------
constexpr int kSplit = 128;          // keys a split: two 64-key tiles
constexpr int kDecThreads = 128;     // 4 warps, 32 keys each for S
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecHeads = 16;        // query heads a block (of one KV head's group): one m16 tile

template <typename KV, int DH>
constexpr size_t dec_smem_bytes() {
  // q, p (bf16, 16 rows) and the split's K and V: bf16 tiles, or the
  // 1-byte codes of both and one bf16 tile each is decoded into in turn
  return static_cast<size_t>(kDecHeads * DH * 2 + kDecHeads * kSplit * 2 +
                             (sizeof(KV) == 1 ? 2 * kSplit * DH + kSplit * DH * 2
                                              : 2 * kSplit * DH * 2));
}

// Decodes the split's 128 rows of 1-byte codes into a bf16 tile (two
// 64-row halves; the swizzle repeats every 8 rows).
template <typename KV, int DH>
__device__ __forceinline__ void decode_split(const uint8_t* codes, uint8_t* out) {
  decode_tile<KV, DH>(codes, out);
  decode_tile<KV, DH>(codes + kBK * DH, out + kBK * DH * 2);
}

// bf16 q, Sq = 1; KV: bf16 or a 1-byte code; PAGED as flash_kernel's (the
// window is read at run time: it only moves the first live key).  Grid
// (splits, KV * head chunks, B), 128 threads.  Block (s, y, b) owns keys
// [128 s, 128 s + 128) of batch row b, KV head y / chunks, and the up to
// 16 query heads of chunk y % chunks of that KV head's group, the rows of
// one m16 tile (rows past the group are zero).  It writes each head's (m,
// l, acc[DH]) of the split to the workspace ws, and flash_decode_combine
// reduces the splits.
template <typename KV, int DH, bool PAGED>
__global__ void __launch_bounds__(kDecThreads, 3) flash_decode_kernel(const Params p, float* ws) {
  using T = __nv_bfloat16;
  constexpr bool QUANT = !std::is_same<T, KV>::value;
  constexpr int ES = static_cast<int>(sizeof(KV));
  constexpr int CPR = DH * ES / 16;          // 16-byte chunks a K/V row as copied
  constexpr int RPP = kDecThreads / CPR;     // rows a pass of the block's copies
  constexpr int BCPR = DH / 8;               // 16-byte chunks a bf16 row
  constexpr int PCPR = kSplit / 8;           // 16-byte chunks a row of p
  constexpr int KV_BYTES = kSplit * DH * ES;
  constexpr int DW = DH / kDecWarps;         // output columns a warp
  static_assert(kSplit % RPP == 0 && BCPR % 8 == 0 && DW % 16 == 0 && kDecThreads == kSplit,
                "tile maps; one table entry a thread");
  extern __shared__ __align__(128) uint8_t dec_smem[];
  const uint32_t q_s = smem_addr(dec_smem);           // [16][DH] bf16, swizzled
  const uint32_t p_s = q_s + kDecHeads * DH * 2;      // [16][kSplit] bf16, swizzled
  const uint32_t k_s = p_s + kDecHeads * kSplit * 2;  // K as copied
  const uint32_t v_s = k_s + KV_BYTES;                // V as copied
  const uint32_t bf = v_s + KV_BYTES;                 // 1-byte cache: the decoded tile
  __shared__ float red[2][kDecWarps][kDecHeads];      // by warp: each row's max, then sum
  __shared__ int tok_row[PAGED ? kSplit : 1];         // paged: pool token row of each key

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ns = gridDim.x, k0 = blockIdx.x * kSplit;
  const int chunks = (p.group + kDecHeads - 1) / kDecHeads;
  const int kvh = blockIdx.y / chunks;
  const int h0 = kvh * p.group + (blockIdx.y % chunks) * kDecHeads;  // the block's first head
  const int nh = min(kDecHeads, (kvh + 1) * p.group - h0);
  const int bi = blockIdx.z;
  int klim = min(p.kv_len[bi], p.sk);
  if (p.causal) klim = min(klim, p.q_start[bi] + 1);
  const int klo = p.win_start != nullptr ? max(p.win_start[bi], 0) : 0;
  // the workspace: (m, l) of (b, h, split), then acc[DH] of each
  float* const ws_ml = ws;
  float* const ws_acc = ws + 2LL * gridDim.z * p.h * ns;
  const long long row0 = (static_cast<long long>(bi) * p.h + h0) * ns + blockIdx.x;

  if (k0 >= klim || k0 + kSplit <= klo) {  // an empty split: nothing loaded, m = -1e30, l = 0
    if (tid < nh) {
      ws_ml[(row0 + tid * ns) * 2] = kNegInf;
      ws_ml[(row0 + tid * ns) * 2 + 1] = 0.f;
    }
    return;
  }
  float sc = p.scale * kLog2e;
  if constexpr (QUANT) sc = p.scale * p.k_scale[bi] * kLog2e;
  if constexpr (PAGED) {
    const int kpos = k0 + tid;
    int tok = -1;
    if (kpos >= klo && kpos < klim) {
      const int pg = p.block_tables[static_cast<long long>(bi) * p.nblocks + kpos / p.page];
      if (pg >= 0 && pg < p.num_pages) tok = pg * p.page + kpos % p.page;
    }
    tok_row[tid] = tok;
    __syncthreads();
  }

  // copy group 0: q (rows past the group zero-filled) and K; group 1: V.
  // 16 bytes a copy; key rows not live are zero-filled and not read.
  const T* __restrict__ qg = static_cast<const T*>(p.q);
#pragma unroll
  for (int j = 0; j < kDecHeads * BCPR / kDecThreads; ++j) {
    const int r = tid / BCPR + j * (kDecThreads / BCPR), c = tid % BCPR;
    const bool ok = r < nh;
    cp_async16(q_s + swz(r, c, BCPR),
               qg + (static_cast<long long>(bi) * p.h + h0 + (ok ? r : 0)) * DH + c * 8, ok);
  }
  const KV* __restrict__ kg = static_cast<const KV*>(p.k);
  const KV* __restrict__ vg = static_cast<const KV*>(p.v);
  const int crow = tid / CPR, cchunk = tid % CPR;
  auto copy = [&](const KV* src, uint32_t dst) {
#pragma unroll
    for (int j = 0; j < kSplit / RPP; ++j) {
      const int r = crow + RPP * j, kp = k0 + r;
      bool ok;
      long long ro;
      if constexpr (PAGED) {
        const int tok = tok_row[r];
        ok = tok >= 0;
        ro = static_cast<long long>(tok) * p.kv;
      } else {
        ok = kp >= klo && kp < klim;
        ro = (static_cast<long long>(bi) * p.sk + kp) * p.kv;
      }
      const long long off = ok ? (ro + kvh) * DH + cchunk * (16 / ES) : 0;
      cp_async16(dst + (QUANT ? static_cast<uint32_t>((r * CPR + cchunk) * 16)
                              : swz(r, cchunk, CPR)),
                 src + off, ok);
    }
  };
  copy(kg, k_s);
  cp_async_commit();
  copy(vg, v_s);
  cp_async_commit();

  cp_async_wait<1>();  // this thread's q and K copies landed
  __syncthreads();     // ... every thread's
  uint32_t ks = k_s, vs = v_s;
  if constexpr (QUANT) {
    decode_split<KV, DH>(dec_smem + (k_s - q_s), dec_smem + (bf - q_s));
    __syncthreads();
    ks = vs = bf;
  }

  // S = q K^T: the 16 head rows against this warp's 32 keys, fp32 sums of
  // exact bf16 products
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldsm_x4(qf[kk], q_s + swz(lane & 15, 2 * kk + (lane >> 4), BCPR));
  const int kw = warp * 32;  // the warp's first key in the split
  float s[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
      uint32_t b[4];
      ldsm_x4(b, ks + swz(kw + n2 * 16 + (lane & 7) + ((lane >> 4) << 3),
                          2 * kk + ((lane >> 3) & 1), BCPR));
      mma_bf16(s[2 * n2], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * n2 + 1], qf[kk], b[2], b[3]);
    }
  }

  // the split's softmax: scale (times k_scale, in log2 units) and mask;
  // each row's max over the split (a row's 4 lanes by shuffles, then the
  // warps in order); p = exp2(s - m) and its sum in fp32; p to bf16 for P.V
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = k0 + kw + n * 8 + 2 * t4 + (e & 1);
      s[n][e] = kpos >= klo && kpos < klim ? s[n][e] * sc : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (t4 == 0) red[0][warp][g + 8 * r] = mx[r];
  }
  __syncthreads();
  float m[2], l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = red[0][0][g + 8 * r];
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) m[r] = fmaxf(m[r], red[0][w][g + 8 * r]);
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = exp2f(s[n][e] - m[e >> 1]);  // 0 for a masked key
      l[e >> 1] += s[n][e];
    }
    // p (bf16) of keys kw + 8 n + 2 t4 + {0, 1}, rows g and g + 8
    const int key = kw + n * 8 + 2 * t4;
    const uint32_t at = swz(g, key >> 3, PCPR) + (key & 7) * 2;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(p_s + at), "r"(pack_bf16(s[n][0], s[n][1])));
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(p_s + at + 8 * PCPR * 16),
                 "r"(pack_bf16(s[n][2], s[n][3])));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (t4 == 0) red[1][warp][g + 8 * r] = l[r];
  }

  cp_async_wait<0>();  // this thread's V copies landed
  __syncthreads();     // ... every thread's; p stored; K no longer read
  if constexpr (QUANT) {
    decode_split<KV, DH>(dec_smem + (v_s - q_s), dec_smem + (bf - q_s));
    __syncthreads();
  }

  // acc = P V: this warp's DW output columns over the split's 128 keys
  float o[DW / 8][4];
#pragma unroll
  for (int d = 0; d < DW / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kSplit / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, p_s + swz(lane & 15, 2 * kk + (lane >> 4), PCPR));
#pragma unroll
    for (int d2 = 0; d2 < DW / 16; ++d2) {
      uint32_t b[4];
      ldsm_x4_trans(b, vs + swz(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                (warp * DW) / 8 + 2 * d2 + (lane >> 4), BCPR));
      mma_bf16(o[2 * d2], a, b[0], b[1]);
      mma_bf16(o[2 * d2 + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row < nh) {
      float* dst = ws_acc + (row0 + row * ns) * DH + warp * DW + 2 * t4;
#pragma unroll
      for (int d = 0; d < DW / 8; ++d)
        *reinterpret_cast<float2*>(dst + 8 * d) = make_float2(o[d][2 * r], o[d][2 * r + 1]);
    }
  }
  if (tid < nh) {
    float mm = red[0][0][tid], ll = red[1][0][tid];
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) {
      mm = fmaxf(mm, red[0][w][tid]);
      ll += red[1][w][tid];
    }
    ws_ml[(row0 + tid * ns) * 2] = mm;
    ws_ml[(row0 + tid * ns) * 2 + 1] = ll;
  }
}

// Grid (H, B), DH threads: thread d of block (h, b) reduces column d of
// head h's splits in split order, 0 .. ns - 1, and writes acc / max(l,
// 1e-30), times v_scale[b], as bf16.  The splits' (m, l) are staged in
// shared memory first.  An empty split (l = 0) has weight exp2(-1e30 - m)
// = 0: it is skipped, which adds exactly what its 0 would, and its acc
// (never written) is loaded but not used.
template <int DH>
__global__ void __launch_bounds__(DH) flash_decode_combine(const Params p, const float* ws,
                                                            int ns) {
  extern __shared__ float ml_s[];  // [ns][2]
  const int hi = blockIdx.x, bi = blockIdx.y, d = threadIdx.x;
  const long long row = (static_cast<long long>(bi) * p.h + hi) * ns;
  const float* __restrict__ ml = ws + row * 2;
  const float* __restrict__ acc = ws + 2LL * gridDim.y * p.h * ns + row * DH + d;
  for (int s = d; s < 2 * ns; s += DH) ml_s[s] = ml[s];
  __syncthreads();
  float m = kNegInf;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, ml_s[2 * s]);
  float l = 0.f, a = 0.f;
#pragma unroll 8
  for (int s = 0; s < ns; ++s) {
    const float ls = ml_s[2 * s + 1];
    const float x = acc[static_cast<long long>(s) * DH];
    const float w = exp2f(ml_s[2 * s] - m);
    l = ls > 0.f ? fmaf(w, ls, l) : l;
    a = ls > 0.f ? fmaf(w, x, a) : a;
  }
  float x = a / fmaxf(l, 1e-30f);
  if (p.v_scale != nullptr) x *= p.v_scale[bi];
  static_cast<__nv_bfloat16*>(p.o)[(static_cast<long long>(bi) * p.h + hi) * DH + d] =
      __float2bfloat16(x);
}

// --------------------------------------------------------------------------
// Launches
// --------------------------------------------------------------------------

// The kernels a launch may take, as repro_flash_attention reports them.
enum KernelId { kFmaKernel = 0, kTensorCoreKernel = 1, kSplitDecodeKernel = 2 };

// What the launch path does: launch, or only report the instance's blocks
// resident on an SM (repro_flash_attention_occupancy), or only the fp32
// workspace it needs (repro_flash_attention_workspace).
enum Mode { kLaunch = 0, kOccupancy = 1, kWorkspace = 2 };

// What a launch took: its kernel, query rows a block and threads, the
// blocks of that instance the CUDA runtime keeps on one SM (kOccupancy),
// and the workspace floats it needs.
struct Launch {
  int mode;
  int kernel, rows, threads, resident;
  long long workspace;
  float* ws;  // the workspace given to a launch (not part of Params: the other kernels'
              // parameters stay as they were)
};

// Launches `kernel` (p, extra...) or, by at.mode, only reports it.
template <typename Kernel, typename... Extra>
int start(Kernel kernel, KernelId id, dim3 grid, int threads, size_t smem, int rows,
          const Params& p, cudaStream_t stream, Launch& at, Extra... extra) {
  at.kernel = id;
  at.rows = rows;
  at.threads = threads;
  if (at.mode == kWorkspace) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (at.mode == kOccupancy)
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&at.resident, kernel, threads, smem));
  kernel<<<grid, threads, smem, stream>>>(p, extra...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV, int DH, int BQ, int TPR, bool PAGED, bool WINDOWED>
int launch(const Params& p, int b, cudaStream_t stream, Launch& at) {
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, b);
  return start(&flash_kernel<T, KV, DH, BQ, TPR, PAGED, WINDOWED>, kFmaKernel, grid, BQ * TPR,
               smem_bytes<DH, BQ>(), BQ, p, stream, at);
}

template <typename KV, int DH, bool PAGED, bool WINDOWED>
int launch_tc(const Params& p, int b, cudaStream_t stream, Launch& at) {
  const dim3 grid(p.h, (p.sq + kTcRows - 1) / kTcRows, b);
  return start(&flash_tc_kernel<KV, DH, PAGED, WINDOWED>, kTensorCoreKernel, grid,
               kTcThreads, tc_smem_bytes<KV, DH>(), kTcRows, p, stream, at);
}

// The split decode kernel, then its combine: one launch of the op.  The
// splits are fixed in logical key positions and their number depends on
// Sk alone, so the grid and the workspace (B * H * splits * (DH + 2)
// floats) read nothing from the device.
template <typename KV, int DH>
int launch_decode(const Params& p, int b, cudaStream_t stream, Launch& at) {
  const int ns = max((p.sk + kSplit - 1) / kSplit, 1);
  const int chunks = (p.group + kDecHeads - 1) / kDecHeads;
  at.workspace = static_cast<long long>(b) * p.h * ns * (DH + 2);
  if (at.mode == kLaunch && at.ws == nullptr) return -1;
  const dim3 grid(ns, p.kv * chunks, b);
  const int err = start(p.block_tables != nullptr ? &flash_decode_kernel<KV, DH, true>
                                                  : &flash_decode_kernel<KV, DH, false>,
                        kSplitDecodeKernel, grid, kDecThreads, dec_smem_bytes<KV, DH>(),
                        kDecHeads, p, stream, at, at.ws);
  if (err != 0 || at.mode != kLaunch) return err;
  flash_decode_combine<DH><<<dim3(p.h, b), DH, 2 * ns * sizeof(float), stream>>>(
      p, static_cast<const float*>(at.ws), ns);
  return static_cast<int>(cudaGetLastError());
}

// TC: the tensor-core kernel, else flash_kernel with BQ rows of TPR threads.
template <bool TC, typename T, typename KV, int DH, int BQ, int TPR, bool PAGED, bool WINDOWED>
int launch_kernel(const Params& p, int b, cudaStream_t stream, Launch& at) {
  if constexpr (TC) return launch_tc<KV, DH, PAGED, WINDOWED>(p, b, stream, at);
  else return launch<T, KV, DH, BQ, TPR, PAGED, WINDOWED>(p, b, stream, at);
}

template <bool TC, typename T, typename KV, int DH, int BQ, int TPR>
int launch_form(const Params& p, int b, cudaStream_t stream, Launch& at) {
  const bool paged = p.block_tables != nullptr, windowed = p.win_start != nullptr;
  if (paged && windowed) return launch_kernel<TC, T, KV, DH, BQ, TPR, true, true>(p, b, stream, at);
  if (paged) return launch_kernel<TC, T, KV, DH, BQ, TPR, true, false>(p, b, stream, at);
  if (windowed) return launch_kernel<TC, T, KV, DH, BQ, TPR, false, true>(p, b, stream, at);
  return launch_kernel<TC, T, KV, DH, BQ, TPR, false, false>(p, b, stream, at);
}

template <typename T, typename KV, int DH>
int launch_rows(const Params& p, int b, cudaStream_t stream, Launch& at) {
  // bf16 q: one row (decode) takes the split decode kernel, more than 16
  // the tensor cores; fp32 q, and bf16 with 2-16 rows, the FMA kernel: 16
  // rows of 16 threads up to 16 rows, 64 rows of 4 above
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (p.sq == 1) return launch_decode<KV, DH>(p, b, stream, at);
    if (p.sq > 16) return launch_form<true, T, KV, DH, 0, 0>(p, b, stream, at);
  }
  if (p.sq <= 16) return launch_form<false, T, KV, DH, 16, 16>(p, b, stream, at);
  return launch_form<false, T, KV, DH, 64, 4>(p, b, stream, at);
}

template <typename T, typename KV>
int launch_dh(int dh, const Params& p, int b, cudaStream_t stream, Launch& at) {
  switch (dh) {
    case 64:
      return launch_rows<T, KV, 64>(p, b, stream, at);
    case 128:
      return launch_rows<T, KV, 128>(p, b, stream, at);
    default:
      return -1;
  }
}

// The cache's element type: q's own without scales, else the code format.
template <typename T>
int launch_kv(int code, int dh, const Params& p, int b, cudaStream_t stream, Launch& at) {
  if (p.k_scale == nullptr) return launch_dh<T, T>(dh, p, b, stream, at);
  switch (code) {
    case repro::kCodeInt8:
      return launch_dh<T, int8_t>(dh, p, b, stream, at);
    case repro::kCodeE4M3:
      return launch_dh<T, __nv_fp8_e4m3>(dh, p, b, stream, at);
    default:
      return -1;
  }
}

int launch_dtype(int dtype, int code, int dh, const Params& p, int b, cudaStream_t stream,
                 Launch& at) {
  switch (dtype) {
    case repro::kFloat32:
      return launch_kv<float>(code, dh, p, b, stream, at);
    case repro::kBFloat16:
      return launch_kv<__nv_bfloat16>(code, dh, p, b, stream, at);
    default:
      return -1;
  }
}

// The launch path without a launch (kOccupancy or kWorkspace) for q of
// `dtype` over a cache of format `code` (-1: q's own dtype): the device
// pointers only select the instance, so any non-null pointer stands in.
int query(int mode, int dtype, int code, int dh, int b, int sq, int sk, int h, int kv, int paged,
          int windowed, Launch& at) {
  static const int kAny = 0;
  static const float kAnyScale = 0.f;
  Params p{};
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.kv = kv;
  p.group = kv > 0 ? h / kv : 0;
  p.block_tables = paged ? &kAny : nullptr;
  p.win_start = windowed ? &kAny : nullptr;
  p.k_scale = p.v_scale = code >= 0 ? &kAnyScale : nullptr;
  at = Launch{mode, -1, 0, 0, 0, 0, nullptr};
  return launch_dtype(dtype, code, dh, p, b, nullptr, at);
}

}  // namespace

// q (B, Sq, H, Dh) and o (B, Sq, H, Dh) contiguous; k/v contiguous, either
// (B, Sk, KV, Dh) with block_tables null, or paged pools (P, page, KV, Dh)
// with block_tables a (B, nblocks) int32 table on the device and
// Sk = nblocks * page the logical extent.  k/v are of q's dtype with
// k_scale and v_scale null, or 1-byte codes of format `code` (int8 0,
// e4m3 1) with k_scale and v_scale (B,) float32 on the device.  kv_len,
// q_start and (when not null) win_start are (B,) int32 on the device; q,
// k, v and o are 16-byte aligned.  ws: a float32 workspace on the device
// of the floats repro_flash_attention_workspace_query gives (null when it
// gives 0).  Launches on `stream`; returns the cudaError_t of the launch
// (0 = ok) or -1 for an unsupported dtype, code format or head_dim, or a
// missing workspace.  *kernel gets the kernel launched (0 flash_kernel, 1
// flash_tc_kernel, 2 flash_decode_kernel and its combine), or -1 when
// nothing was launched.
int repro_flash_attention_launch(int dtype, int code, int dh, const void* q, const void* k,
                                 const void* v, void* o, const int* kv_len, const int* q_start,
                                 const int* block_tables, int nblocks, int page, int num_pages,
                                 const int* win_start, const float* k_scale,
                                 const float* v_scale, float* ws, int b, int sq, int sk, int h,
                                 int kv, float scale, int causal, int static_diag, void* stream,
                                 int* kernel) {
  *kernel = -1;
  if (b == 0 || sq == 0 || h == 0) return 0;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return -1;
  const Params p{q,       k,       v,  o,  kv_len, q_start, block_tables, win_start,
                 k_scale, v_scale, sq, sk, h,      kv,      h / kv,       page,
                 num_pages, nblocks, scale, causal, static_diag};
  Launch at{kLaunch, -1, 0, 0, 0, 0, ws};
  const int err = launch_dtype(dtype, code, dh, p, b, static_cast<cudaStream_t>(stream), at);
  if (err == 0) *kernel = at.kernel;
  return err;
}

// For a launch of Sq query rows of q in `dtype` over a cache of format
// `code` (-1: q's own dtype), head width dh, paged and windowed or not, on
// the current device: the kernel it takes (as *kernel above), that
// kernel's query rows a block (the split decode kernel: query heads), its
// threads, and its blocks resident on one SM as the CUDA runtime reports
// them.  Launches nothing.
int repro_flash_attention_occupancy_query(int dtype, int code, int dh, int sq, int paged,
                                          int windowed, int* kernel, int* rows, int* threads,
                                          int* resident) {
  Launch at;
  const int err = query(kOccupancy, dtype, code, dh, 1, sq, 0, 0, 0, paged, windowed, at);
  *kernel = at.kernel;
  *rows = at.rows;
  *threads = at.threads;
  *resident = at.resident;
  return err;
}

// For a launch of q (B, Sq, H, Dh) in `dtype` over Sk logical keys of KV
// heads in format `code` (-1: q's own dtype): *floats gets the float32
// workspace floats the launch needs (0 unless it takes the split decode
// kernel), by the rule the launch itself applies.  Touches no device.
int repro_flash_attention_workspace_query(int dtype, int code, int dh, int b, int sq, int sk,
                                          int h, int kv, long long* floats) {
  Launch at;
  const int err = query(kWorkspace, dtype, code, dh, b, sq, sk, h, kv, 0, 0, at);
  *floats = at.workspace;
  return err;
}
