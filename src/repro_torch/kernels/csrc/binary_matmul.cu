// Packed 1-bit matmul with Eq.-9 scales for Hopper (sm_90a):
//
//   y = ((x * a_in) @ sign) * a_out
//
// Replaces the Pallas TPU kernel src/repro/kernels/binary_matmul.py
// (`binary_matmul`, pallas_call at :75).  The kernel body is the binary span
// of span_matmul.cuh (design, bound and numerics are described there).
#include "span_matmul.cuh"

// x (M, K) bf16 contiguous; bits (K/8, N) u8, bit j of byte i = channel
// 8i+j; alpha_in (K,) f32; alpha_out (N,) f32; y (M, N) bf16.  K is a
// multiple of 8.  Launches on `stream` and returns cudaGetLastError().
extern "C" int binary_matmul_launch(const void* x, const void* bits,
                                    const void* alpha_in,
                                    const void* alpha_out, void* y, int M,
                                    int N, int K, void* stream) {
  return static_cast<int>(span::launch<span::Kind::kBinary>(
      x, bits, alpha_in, nullptr, alpha_out, y, M, N, K, stream));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
