// One packed span of the PTQ1.61 linear on its own, for Hopper (sm_90a):
//
//   int4:    y = x @ ((q - z) * s)                 s, z per input channel
//   binary:  y = ((x * a_in) @ sign) * a_out       a_in (K,), a_out (N,)
//
// Shared by binary_matmul.cu and int4_matmul.cu, which replace the Pallas
// TPU kernels src/repro/kernels/binary_matmul.py (`binary_matmul`) and
// src/repro/kernels/int4_matmul.py (`int4_matmul`).  The loops are those of
// the matching span of mixed_matmul.cu, with one span per launch.
//
// What bounds it: at decode (M = 1..8) the packed weight bytes, which every
// launch must stream once.  A block owns 64 output columns (2 per lane) and
// all of its BM rows; its 8 warps split K, and the partial sums meet in
// shared memory, so each packed byte is read once per launch when M <= 8.
// Larger M runs in 8-row tiles (grid.y), which re-read the weights from L2.
// The products run on the CUDA cores in f32 (tensor-core tiles are later
// work).
//
// Numerics follow the TPU kernels: x is bf16; the int4 weight (q - z) * s
// is computed in f32 and rounded to bf16; the binary operand x * a_in is
// computed in f32 and rounded to bf16; sums are f32, and the output is the
// f32 result rounded once to bf16.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace span {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 64;      // output columns per block (2 per lane)
constexpr int kKC = 1024;    // channels staged per chunk

enum class Kind { kInt4, kBinary };

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

// Weight of channel h (0..per-1) of packed byte b for column n, before
// any output scale: a dequantized int4 code or a sign.
template <Kind S>
__device__ __forceinline__ float weight(uint32_t b, int h, float s, float z) {
  if constexpr (S == Kind::kInt4) {
    return bf16_round((float((b >> (4 * h)) & 15u) - z) * s);
  } else {
    return ((b >> h) & 1u) ? 1.f : -1.f;
  }
}

// x (M, K) bf16; packed (K / per, N) u8; int4: ka = s, kb = z (K,) f32;
// binary: ka = a_in (K,) f32, out_scale = a_out (N,) f32; y (M, N) bf16.
template <Kind S, int BM>
__global__ void __launch_bounds__(kThreads)
span_kernel(const __nv_bfloat16* __restrict__ x,
            const uint8_t* __restrict__ packed,
            const float* __restrict__ ka, const float* __restrict__ kb,
            const float* __restrict__ out_scale,
            __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  constexpr int per = S == Kind::kInt4 ? 2 : 8;   // channels per byte
  // staged activations, laid out [channel][row]; reused for the reduction
  __shared__ __align__(16) float xs[kKC * BM];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN + lane * 2;
  const int row0 = blockIdx.y * BM;
  const bool ok0 = n0 < N;
  const bool ok1 = n0 + 1 < N;

  float acc[BM][2];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m][0] = acc[m][1] = 0.f;

  for (int kc = 0; kc < K; kc += kKC) {
    const int kn = min(kKC, K - kc);
    __syncthreads();
    for (int kk = tid; kk < kn; kk += kThreads) {
      const int k = kc + kk;
      const float a = S == Kind::kBinary ? ka[k] : 1.f;
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const int row = row0 + m;
        float v = row < M ? __bfloat162float(x[(size_t)row * K + k]) : 0.f;
        if constexpr (S == Kind::kBinary) v = bf16_round(v * a);
        xs[kk * BM + m] = v;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int g = warp; g < kn / per; g += kWarps) {
      const int r = kc / per + g;
      const uint32_t b0 = ok0 ? packed[(size_t)r * N + n0] : 0u;
      const uint32_t b1 = ok1 ? packed[(size_t)r * N + n0 + 1] : 0u;
#pragma unroll
      for (int h = 0; h < per; ++h) {
        const int k = per * r + h;
        const float s = S == Kind::kInt4 ? ka[k] : 0.f;
        const float z = S == Kind::kInt4 ? kb[k] : 0.f;
        const float wa = weight<S>(b0, h, s, z);
        const float wb = weight<S>(b1, h, s, z);
        float xv[BM];
        load_rows<BM>(&xs[(per * g + h) * BM], xv);
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          acc[m][0] = fmaf(xv[m], wa, acc[m][0]);
          acc[m][1] = fmaf(xv[m], wb, acc[m][1]);
        }
      }
    }
  }

  // ---- epilogue: per-warp partial y, reduced across the K-split warps ----
  __syncthreads();
  float* red = xs;  // [warp][row][column]: kWarps * BM * kBN <= kKC * BM
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    red[(warp * BM + m) * kBN + lane * 2] = acc[m][0];
    red[(warp * BM + m) * kBN + lane * 2 + 1] = acc[m][1];
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
    if (row < M && col < N) {
      if constexpr (S == Kind::kBinary) s *= out_scale[col];
      y[(size_t)row * N + col] = __float2bfloat16_rn(s);
    }
  }
}

template <Kind S, int BM>
cudaError_t launch_bm(const void* x, const void* packed, const void* ka,
                      const void* kb, const void* out_scale, void* y, int M,
                      int N, int K, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  span_kernel<S, BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(packed), static_cast<const float*>(ka),
      static_cast<const float*>(kb), static_cast<const float*>(out_scale),
      static_cast<__nv_bfloat16*>(y), M, N, K);
  return cudaGetLastError();
}

// Picks the row tile from M and launches on `stream`; returns
// cudaGetLastError().
template <Kind S>
cudaError_t launch(const void* x, const void* packed, const void* ka,
                   const void* kb, const void* out_scale, void* y, int M,
                   int N, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 1) return launch_bm<S, 1>(x, packed, ka, kb, out_scale, y, M, N, K, st);
  if (M <= 2) return launch_bm<S, 2>(x, packed, ka, kb, out_scale, y, M, N, K, st);
  if (M <= 4) return launch_bm<S, 4>(x, packed, ka, kb, out_scale, y, M, N, K, st);
  return launch_bm<S, 8>(x, packed, ka, kb, out_scale, y, M, N, K, st);
}

}  // namespace span
