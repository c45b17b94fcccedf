// Shared helpers for the port's CUDA kernels.
//
// The kernels read and write either float32 or bfloat16 and do all their
// arithmetic in float32, as the Pallas kernels they replace do; quantized
// weights and KV caches are 1-byte int8 or e4m3 codes, converted to float32,
// or for a tensor-core product to bf16, exactly.  Only the conversion intrinsics are used, so the sources compile
// under PyTorch's extension flags (-D__CUDA_NO_BFLOAT16_CONVERSIONS__ and
// friends).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with the Python wrappers (kernels/_build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// 1-byte code formats shared with the Python wrappers (quant_matmul.py,
// flash_attention.py)
constexpr int kCodeInt8 = 0;
constexpr int kCodeE4M3 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype(bfloat16)
}

// 16-byte loads of N consecutive elements, converted to float.  The
// pointer must be 16-byte aligned (the wrappers check the base pointers;
// offsets are multiples of N).
template <typename T>
struct VecLoad;

template <>
struct VecLoad<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
};

template <>
struct VecLoad<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float half_bits_to_float(unsigned short h) {
  float f;
  asm("cvt.f32.f16 %0, %1;" : "=f"(f) : "h"(h));
  return f;
}

// 4 int8 codes of one 32-bit word (lowest byte first) to fp32, exactly.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* out) {
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = static_cast<float>(static_cast<int8_t>(w >> (8 * j)));
}

// 4 e4m3 codes of one 32-bit word (lowest byte first) to fp32, exactly:
// every e4m3 value is a half, and every half a float.
__device__ __forceinline__ void e4m3x4_to_float(uint32_t w, float* out) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> (16 * j)), __NV_E4M3);  // low byte -> .x
    out[2 * j] = half_bits_to_float(h.x);
    out[2 * j + 1] = half_bits_to_float(h.y);
  }
}

// (a & b) | c in one instruction (the compiler splits it when b and c are
// both literals).
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// Two codes, the low bytes of t's two 16-bit halves (bits 8..15 and 24..31
// are ignored), to a bf16 pair (low half first), exactly, with no
// conversion instruction: every int8 code and every finite e4m3 value is a
// bf16.
//
// int8 c = l - 128 s (l its low 7 bits, s its sign bit): bf16 0x4300 | l
// is 128 + l, bf16 0xC300 | s << 7 is -(128 + 128 s), and their sum (one
// bf16x2 FMA by 1) is exact.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t t) {
  const uint32_t lo = and_or(t, 0x007F007Fu, 0x43004300u);   // 128 + l
  const uint32_t nhi = and_or(t, 0x00800080u, 0xC300C300u);  // -(128 + 128 s)
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(lo), "r"(0x3F803F80u), "r"(nhi));
  return r;
}

// e4m3 s.eeee.mmm: the sign to bf16's sign and eeee.mmm to bits 10..4 give
// the bf16 2^-120 times the code (a normal bf16 for a normal code, a
// subnormal one for a subnormal code); times 2^120 (0x7B80, plus -0) it
// is exact.  The two NaN patterns (0x7F, 0xFF), which the quantizer never
// writes, would read as +-480.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t t) {
  const uint32_t v = and_or(t << 8, 0x80008000u, (t << 4) & 0x07F007F0u);
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(0x7B807B80u), "r"(0x80008000u));
  return r;
}

// 16 one-byte codes a vector.
template <>
struct VecLoad<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    int8x4_to_float(u.x, out);
    int8x4_to_float(u.y, out + 4);
    int8x4_to_float(u.z, out + 8);
    int8x4_to_float(u.w, out + 12);
  }
};

template <>
struct VecLoad<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const __nv_fp8_e4m3* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    e4m3x4_to_float(u.x, out);
    e4m3x4_to_float(u.y, out + 4);
    e4m3x4_to_float(u.z, out + 8);
    e4m3x4_to_float(u.w, out + 12);
  }
};

// The matching 16-byte stores, rounding to T as from_float does.
template <typename T>
struct VecStore;

template <>
struct VecStore<float> {
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct VecStore<__nv_bfloat16> {
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// The shared-memory address of a pointer into shared memory.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, or 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The bf16 tensor-core tiles of the flash and moe_gmm kernels: operands in
// shared memory as rows of 16-byte chunks, read by ldmatrix into mma.sync
// fragments.

// Byte offset of 16-byte chunk c of row r in a tile of `cpr` chunks a row
// (a multiple of 8), chunk c stored at c ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int c, int cpr) {
  return static_cast<uint32_t>((r * cpr + (c ^ (r & 7))) << 4);
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i .. 8i + 7 give the
// row addresses of matrix i, and r[i] holds this lane's pair of it (row
// lane / 4, columns 2 (lane % 4) + 0, 1), or with .trans of its transpose.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row-major fragment) * b (16 x 8,
// bf16, column fragment b0 b1).  Lane l holds d rows l / 4 (d[0], d[1])
// and l / 4 + 8 (d[2], d[3]), columns 2 (l % 4) + 0, 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats to a bf16 pair (lo in the low half), rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace repro
