// C entry points of the port's CUDA kernels, bound from Python with ctypes
// (repro_torch/kernels/_build.py).
//
// The library is built by torch.utils.cpp_extension.load as a plain shared
// library (is_python_module=False): no source includes PyTorch's headers,
// so the build takes seconds.  Tensors arrive as raw device pointers the
// Python wrappers have already checked (device, dtype, shape, contiguity);
// every launch goes on the caller's stream and returns its cudaError_t.
#include <cuda_runtime_api.h>

int repro_rmsnorm_launch(int dtype, const void* x, const void* w, void* y, long long rows,
                         int d, float eps, void* stream);

int repro_flash_attention_launch(int dtype, int code, int dh, const void* q, const void* k,
                                 const void* v, void* o, const int* kv_len, const int* q_start,
                                 const int* block_tables, int nblocks, int page, int num_pages,
                                 const int* win_start, const float* k_scale,
                                 const float* v_scale, float* ws, int b, int sq, int sk, int h,
                                 int kv, float scale, int causal, int static_diag, void* stream,
                                 int* kernel);

int repro_flash_attention_occupancy_query(int dtype, int code, int dh, int sq, int paged,
                                          int windowed, int* kernel, int* rows, int* threads,
                                          int* resident);

int repro_flash_attention_workspace_query(int dtype, int code, int dh, int b, int sq, int sk,
                                          int h, int kv, long long* floats);

int repro_moe_gmm_launch(int dtype, const void* x, const void* w, const int* group_sizes,
                         void* out, long long t, int d, int f, int e, void* stream,
                         int* kernel);

int repro_quant_matmul_launch(int dtype, int code, const void* x, const void* q,
                              const float* scale, void* out, float* ws, long long t, int d,
                              int f, int splits, int kchunk, void* stream);

int repro_ssd_scan_launch(int dtype, const void* x, const float* dt, const float* a,
                          const void* bm, const void* cm, void* y, float* state, int b, int s,
                          int h, int p, int g, int n, int chunk, void* stream);

int repro_quant_matmul_occupancy_query(int dtype, int code, long long t, int* rows,
                                       int* resident, int* sms);

extern "C" {

int repro_rmsnorm(int dtype, const void* x, const void* w, void* y, long long rows, int d,
                  float eps, void* stream) {
  return repro_rmsnorm_launch(dtype, x, w, y, rows, d, eps, stream);
}

// block_tables, win_start and the scales may be null (contiguous KV, no
// window, a full-precision cache); `code` is read only with the scales.
// ws: the float32 workspace repro_flash_attention_workspace sizes (null
// when that is 0).  *kernel gets the kernel launched (0 the FMA kernel, 1
// the tensor-core kernel, 2 the split decode kernel; -1 none).
int repro_flash_attention(int dtype, int code, int dh, const void* q, const void* k,
                          const void* v, void* o, const void* kv_len, const void* q_start,
                          const void* block_tables, int nblocks, int page, int num_pages,
                          const void* win_start, const void* k_scale, const void* v_scale,
                          void* ws, int b, int sq, int sk, int h, int kv, float scale,
                          int causal, int static_diag, void* stream, int* kernel) {
  return repro_flash_attention_launch(
      dtype, code, dh, q, k, v, o, static_cast<const int*>(kv_len),
      static_cast<const int*>(q_start), static_cast<const int*>(block_tables), nblocks, page,
      num_pages, static_cast<const int*>(win_start), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<float*>(ws), b, sq, sk, h, kv, scale,
      causal, static_diag, stream, kernel);
}

// For a launch of q (B, Sq, H, Dh) in `dtype` over Sk keys of KV heads in
// format `code` (-1: q's own dtype): the float32 workspace it needs, in
// floats (0 unless it takes the split decode kernel).
int repro_flash_attention_workspace(int dtype, int code, int dh, int b, int sq, int sk, int h,
                                    int kv, long long* floats) {
  return repro_flash_attention_workspace_query(dtype, code, dh, b, sq, sk, h, kv, floats);
}

// For a launch of Sq rows of q in `dtype` over a cache of format `code`
// (-1: q's own dtype) on the current device: the kernel it takes (as
// above), that kernel's query rows a block, its threads, and its blocks
// resident on one SM.
int repro_flash_attention_occupancy(int dtype, int code, int dh, int sq, int paged,
                                    int windowed, int* kernel, int* rows, int* threads,
                                    int* resident) {
  return repro_flash_attention_occupancy_query(dtype, code, dh, sq, paged, windowed, kernel,
                                               rows, threads, resident);
}

// *kernel gets the kernel launched (0 the FMA kernel, 1 the tensor-core
// kernel; -1 none).
int repro_moe_gmm(int dtype, const void* x, const void* w, const void* group_sizes, void* out,
                  long long t, int d, int f, int e, void* stream, int* kernel) {
  return repro_moe_gmm_launch(dtype, x, w, static_cast<const int*>(group_sizes), out, t, d, f,
                              e, stream, kernel);
}

// ws may be null when splits == 1.
int repro_quant_matmul(int dtype, int code, const void* x, const void* q, const void* scale,
                       void* out, void* ws, long long t, int d, int f, int splits, int kchunk,
                       void* stream) {
  return repro_quant_matmul_launch(dtype, code, x, q, static_cast<const float*>(scale), out,
                                   static_cast<float*>(ws), t, d, f, splits, kchunk, stream);
}

// For a launch of T rows on the current device: its kernel's row tile, the
// blocks of that kernel resident on one SM, and the device's SM count.
int repro_quant_matmul_occupancy(int dtype, int code, long long t, int* rows, int* resident,
                                 int* sms) {
  return repro_quant_matmul_occupancy_query(dtype, code, t, rows, resident, sms);
}

int repro_ssd_scan(int dtype, const void* x, const void* dt, const void* a, const void* bm,
                   const void* cm, void* y, void* state, int b, int s, int h, int p, int g,
                   int n, int chunk, void* stream) {
  return repro_ssd_scan_launch(dtype, x, static_cast<const float*>(dt),
                               static_cast<const float*>(a), bm, cm, y,
                               static_cast<float*>(state), b, s, h, p, g, n, chunk, stream);
}

const char* repro_error_string(int code) {
  if (code < 0)
    return "unsupported dtype, head_dim, code format, split, chunk or state size, or a "
           "missing workspace";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
