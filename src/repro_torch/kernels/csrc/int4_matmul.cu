// Packed int4 matmul with per-input-channel scale and zero point for
// Hopper (sm_90a):
//
//   y = x @ ((q - z) * s)
//
// Replaces the Pallas TPU kernel src/repro/kernels/int4_matmul.py
// (`int4_matmul`, pallas_call at :61).  The kernel body is the int4 span of
// span_matmul.cuh (design, bound and numerics are described there).
#include "span_matmul.cuh"

// x (M, K) bf16 contiguous; w4 (K/2, N) u8, low nibble = even channel;
// s4, z4 (K,) f32; y (M, N) bf16.  K is even.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int int4_matmul_launch(const void* x, const void* w4,
                                  const void* s4, const void* z4, void* y,
                                  int M, int N, int K, void* stream) {
  return static_cast<int>(span::launch<span::Kind::kInt4>(
      x, w4, s4, z4, nullptr, y, M, N, K, stream));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
