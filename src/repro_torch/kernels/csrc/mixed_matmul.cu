// Fused PTQ1.61 linear for Hopper (sm_90a):
//
//   y = x_s @ ((q - z) * s)  +  ((x_b * a_r2) @ sign) * (a_s * a_r1)
//
// Replaces the Pallas TPU kernel src/repro/kernels/mixed_matmul.py
// (`mixed_matmul`, pallas_call at :158, and its in-kernel-gather variant at
// :166): one launch runs the int4 span and then the binary span into the same
// accumulators, so (M, N) is written once.  The activation x arrives in its
// original channel order and is gathered by `perm` while it is staged into
// shared memory; no permuted copy of x is ever written.  With perm == nullptr
// x is taken as already salient-first.
//
// What bounds it: at decode (M = 1..8) the packed weight bytes, which every
// launch must stream once (about 0.5 bytes per weight).  The design reads
// each packed byte exactly once per launch when M <= 8: a block owns 64
// output columns and all of its M rows, its 8 warps split K, and the partial
// sums meet in shared memory.  Larger M runs in 8-row tiles (grid.y), which
// re-read the weights from L2.  The products run on the CUDA cores in f32;
// tensor-core (mma / wgmma) tiles are later work.
//
// Numerics follow the TPU kernel: bf16 operands, int4 weights dequantized in
// f32 and rounded to bf16, x_b * a_r2 computed in f32 and rounded to bf16,
// f32 accumulation.  Shapes: any N; k_s even; k_b a multiple of 8 (what the
// packing allows).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 64;         // output columns per block (2 per lane)
constexpr int kKC4 = 512;       // int4-span channels staged per chunk
constexpr int kKCB = 1024;      // binary-span channels staged per chunk
constexpr int kKCMax = 1024;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int BM>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[BM]) {
  if constexpr (BM % 4 == 0) {
#pragma unroll
    for (int m = 0; m < BM; m += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + m);
      v[m] = t.x; v[m + 1] = t.y; v[m + 2] = t.z; v[m + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < BM; ++m) v[m] = p[m];
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
mixed_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                    const int* __restrict__ perm,
                    const uint8_t* __restrict__ w4,
                    const float* __restrict__ s4,
                    const float* __restrict__ z4,
                    const uint8_t* __restrict__ bits,
                    const float* __restrict__ alpha_s,
                    const float* __restrict__ alpha_r1,
                    const float* __restrict__ alpha_r2,
                    __nv_bfloat16* __restrict__ y, int M, int N, int K, int k_s) {
  // staged activations, laid out [channel][row]; reused for the reduction
  __shared__ __align__(16) float xs[kKCMax * BM];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN + lane * 2;
  const int row0 = blockIdx.y * BM;
  const bool ok0 = n0 < N;
  const bool ok1 = n0 + 1 < N;
  const int k_b = K - k_s;

  float acc4[BM][2];
  float accb[BM][2];
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    acc4[m][0] = acc4[m][1] = 0.f;
    accb[m][0] = accb[m][1] = 0.f;
  }

  // ---- int4 span: channels [0, k_s), one nibble byte = 2 channels ----
  for (int kc = 0; kc < k_s; kc += kKC4) {
    const int kn = min(kKC4, k_s - kc);
    __syncthreads();
    for (int kk = tid; kk < kn; kk += kThreads) {
      const int k = kc + kk;
      const int src = perm ? perm[k] : k;
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const int row = row0 + m;
        xs[kk * BM + m] = row < M
            ? __bfloat162float(x[(size_t)row * K + src]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int g = warp; g < kn / 2; g += kWarps) {
      const int r = (kc >> 1) + g;
      const uint32_t b0 = ok0 ? w4[(size_t)r * N + n0] : 0u;
      const uint32_t b1 = ok1 ? w4[(size_t)r * N + n0 + 1] : 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * r + h;
        const float s = s4[k];
        const float z = z4[k];
        const float wa = bf16_round((float((b0 >> (4 * h)) & 15u) - z) * s);
        const float wb = bf16_round((float((b1 >> (4 * h)) & 15u) - z) * s);
        float xv[BM];
        load_rows<BM>(&xs[(2 * g + h) * BM], xv);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          acc4[m][0] = fmaf(xv[m], wa, acc4[m][0]);
          acc4[m][1] = fmaf(xv[m], wb, acc4[m][1]);
        }
      }
    }
  }

  // ---- binary span: channels [k_s, K), one sign byte = 8 channels ----
  for (int kc = 0; kc < k_b; kc += kKCB) {
    const int kn = min(kKCB, k_b - kc);
    __syncthreads();
    for (int kk = tid; kk < kn; kk += kThreads) {
      const int k = k_s + kc + kk;
      const int src = perm ? perm[k] : k;
      const float a = alpha_r2[kc + kk];
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const int row = row0 + m;
        xs[kk * BM + m] = row < M
            ? bf16_round(__bfloat162float(x[(size_t)row * K + src]) * a)
            : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int g = warp; g < kn / 8; g += kWarps) {
      const int r = (kc >> 3) + g;
      const uint32_t b0 = ok0 ? bits[(size_t)r * N + n0] : 0u;
      const uint32_t b1 = ok1 ? bits[(size_t)r * N + n0 + 1] : 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sa = ((b0 >> j) & 1u) ? 1.f : -1.f;
        const float sb = ((b1 >> j) & 1u) ? 1.f : -1.f;
        float xv[BM];
        load_rows<BM>(&xs[(8 * g + j) * BM], xv);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          accb[m][0] = fmaf(xv[m], sa, accb[m][0]);
          accb[m][1] = fmaf(xv[m], sb, accb[m][1]);
        }
      }
    }
  }

  // ---- epilogue: per-warp partial y, reduced across the K-split warps ----
  const float ao0 = ok0 ? alpha_s[n0] * alpha_r1[n0] : 0.f;
  const float ao1 = ok1 ? alpha_s[n0 + 1] * alpha_r1[n0 + 1] : 0.f;
  __syncthreads();
  float* red = xs;  // [warp][row][column]: kWarps * BM * kBN <= kKCMax * BM
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    red[(warp * BM + m) * kBN + lane * 2] = acc4[m][0] + accb[m][0] * ao0;
    red[(warp * BM + m) * kBN + lane * 2 + 1] = acc4[m][1] + accb[m][1] * ao1;
  }
  __syncthreads();
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int m = i / kBN;
    const int c = i % kBN;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * BM + m) * kBN + c];
    const int row = row0 + m;
    const int col = blockIdx.x * kBN + c;
    if (row < M && col < N) y[(size_t)row * N + col] = __float2bfloat16_rn(s);
  }
}

template <int BM>
cudaError_t launch_bm(const void* x, const void* perm, const void* w4,
                      const void* s4, const void* z4, const void* bits,
                      const void* alpha_s, const void* alpha_r1,
                      const void* alpha_r2, void* y, int M, int N, int K,
                      int k_s, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* pp = static_cast<const int*>(perm);
  const auto* w4p = static_cast<const uint8_t*>(w4);
  const auto* s4p = static_cast<const float*>(s4);
  const auto* z4p = static_cast<const float*>(z4);
  const auto* bp = static_cast<const uint8_t*>(bits);
  const auto* asp = static_cast<const float*>(alpha_s);
  const auto* a1p = static_cast<const float*>(alpha_r1);
  const auto* a2p = static_cast<const float*>(alpha_r2);
  mixed_matmul_kernel<BM><<<grid, kThreads, 0, stream>>>(
      xp, pp, w4p, s4p, z4p, bp, asp, a1p, a2p,
      static_cast<__nv_bfloat16*>(y), M, N, K, k_s);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 contiguous; perm (K,) int32 or null; w4 (k_s/2, N) u8;
// s4, z4 (k_s,) f32; bits (k_b/8, N) u8; alpha_s, alpha_r1 (N,) f32;
// alpha_r2 (k_b,) f32; y (M, N) bf16, the f32 accumulator rounded once.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int mixed_matmul_launch(const void* x, const void* perm,
                                   const void* w4, const void* s4,
                                   const void* z4, const void* bits,
                                   const void* alpha_s, const void* alpha_r1,
                                   const void* alpha_r2, void* y, int M,
                                   int N, int K, int k_s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M <= 1) {
    err = launch_bm<1>(x, perm, w4, s4, z4, bits, alpha_s, alpha_r1,
                       alpha_r2, y, M, N, K, k_s, st);
  } else if (M <= 2) {
    err = launch_bm<2>(x, perm, w4, s4, z4, bits, alpha_s, alpha_r1,
                       alpha_r2, y, M, N, K, k_s, st);
  } else if (M <= 4) {
    err = launch_bm<4>(x, perm, w4, s4, z4, bits, alpha_s, alpha_r1,
                       alpha_r2, y, M, N, K, k_s, st);
  } else {
    err = launch_bm<8>(x, perm, w4, s4, z4, bits, alpha_s, alpha_r1,
                       alpha_r2, y, M, N, K, k_s, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
