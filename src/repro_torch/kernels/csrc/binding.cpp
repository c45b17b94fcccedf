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

int repro_flash_attention_launch(int dtype, int dh, const void* q, const void* k,
                                 const void* v, void* o, const int* kv_len, const int* q_start,
                                 const int* block_tables, int nblocks, int page, int num_pages,
                                 const int* win_start, int b, int sq, int sk, int h, int kv,
                                 float scale, int causal, int static_diag, void* stream);

extern "C" {

int repro_rmsnorm(int dtype, const void* x, const void* w, void* y, long long rows, int d,
                  float eps, void* stream) {
  return repro_rmsnorm_launch(dtype, x, w, y, rows, d, eps, stream);
}

// block_tables and win_start may be null (contiguous KV, no window).
int repro_flash_attention(int dtype, int dh, const void* q, const void* k, const void* v,
                          void* o, const void* kv_len, const void* q_start,
                          const void* block_tables, int nblocks, int page, int num_pages,
                          const void* win_start, int b, int sq, int sk, int h, int kv,
                          float scale, int causal, int static_diag, void* stream) {
  return repro_flash_attention_launch(
      dtype, dh, q, k, v, o, static_cast<const int*>(kv_len), static_cast<const int*>(q_start),
      static_cast<const int*>(block_tables), nblocks, page, num_pages,
      static_cast<const int*>(win_start), b, sq, sk, h, kv, scale, causal, static_diag, stream);
}

const char* repro_error_string(int code) {
  if (code < 0) return "unsupported dtype or head_dim";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
