// Pieces shared by the two paged attention kernels (paged_attention.cu,
// paged_prefill.cu): conversions, cp.async and mma.sync wrappers, the
// 16-byte row copies, and the kernel that combines per-split partials.
//
// A split attention kernel writes, for every query row and split, the
// split's running max m, its denominator l and its unnormalised f32
// accumulator acc (dh values).  A split that saw no live key writes
// l = 0 and no acc.  combine_splits_kernel then reads a row's splits in
// split order; the fixed order gives the same bits on every call.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes = 0 fills zeros (src must
// still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Copy 16-byte chunk c of a row of n elements from src (global) to dst
// (shared; its rows are padded to a multiple of 16 bytes): by cp.async
// when vec (the caller checked n * sizeof(T) % 16 == 0 and the
// alignment), else by plain loads that write zeros past n.  src ==
// nullptr writes zeros; `any` is a valid address for the empty copy.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int c, int n,
                                           bool vec, const T* any) {
  constexpr int kEpc = 16 / sizeof(T);
  if (vec) {
    cp_async16(dst + c * kEpc, src ? src + c * kEpc : any, src ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < kEpc; ++e) {
      const int d = c * kEpc + e;
      dst[d] = (src && d < n) ? src[d] : zero<T>();
    }
  }
}

// Division by a runtime n that is usually a power of two (page sizes,
// GQA group sizes): by shift and mask then, else by division.
struct Div {
  int n, shift;
  __device__ explicit Div(int n_) : n(n_), shift(0) {
    while ((1 << shift) < n) ++shift;
    if ((1 << shift) != n) shift = -1;
  }
  __device__ int quot(int x) const { return shift >= 0 ? x >> shift : x / n; }
  __device__ int rem(int x) const {
    return shift >= 0 ? (x & (n - 1)) : x % n;
  }
};

// Chunks i = tid, tid + nthreads, ... of rows of cpr chunks, as (row j,
// chunk c), stepped without a division.
struct ChunkWalk {
  int j, c, dj, dc, cpr;
  __device__ ChunkWalk(int tid, int nthreads, int cpr_)
      : j(tid / cpr_), c(tid % cpr_), dj(nthreads / cpr_),
        dc(nthreads % cpr_), cpr(cpr_) {}
  __device__ void next() {
    j += dj;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++j;
    }
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Not volatile: a pure register operation, ordered by its operands, so
// the compiler may interleave it with the ldmatrix loads.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The split workspace (index.SplitPlan.ws_floats): ml (splits, rows, 2)
// f32, padded to 16 bytes, then acc (splits, rows, dh) f32.
struct Partials {
  float* ml;
  float* acc;
  __host__ __device__ Partials(void* ws, int splits, int rows) {
    ml = static_cast<float*>(ws);
    acc = ml + ((size_t)splits * rows * 2 + 3) / 4 * 4;
  }
  __device__ float2* ml_at(int split, int rows, size_t row) const {
    return reinterpret_cast<float2*>(ml) + (size_t)split * rows + row;
  }
};

constexpr int kCombineWarps = 8;

// One warp per output row: out[row] = sum_s exp(m_s - M) acc_s /
// sum_s exp(m_s - M) l_s over the splits with l_s > 0, in split order, M
// their largest m_s; 0 when there are none.  Lane j holds split s0 + j's
// (m, l); each lane sums 4 consecutive head dims (a float4 when dh % 4 ==
// 0), the row in ceil(dh / 128) passes.
__global__ void __launch_bounds__(kCombineWarps * 32)
combine_splits_kernel(const float* __restrict__ ws_ml,
                      const float* __restrict__ ws_acc,
                      float* __restrict__ out, int rows, int dh,
                      int splits) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float2* ml = reinterpret_cast<const float2*>(ws_ml);
  float m_max = kNegInf;
  for (int s = lane; s < splits; s += 32) {
    const float2 p = ml[(size_t)s * rows + row];
    if (p.y > 0.f) m_max = fmaxf(m_max, p.x);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m_max = fmaxf(m_max, __shfl_xor_sync(0xffffffffu, m_max, o));
  const bool vec4 = dh % 4 == 0;
  for (int d0 = lane * 4; d0 < dh; d0 += 128) {
    float l = 0.f;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < splits; s0 += 32) {
      const int s_lane = s0 + lane;
      const float2 p = s_lane < splits ? ml[(size_t)s_lane * rows + row]
                                       : make_float2(kNegInf, 0.f);
      const float e_lane = p.y > 0.f ? expf(p.x - m_max) : 0.f;
      const int n = min(32, splits - s0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float e = __shfl_sync(0xffffffffu, e_lane, j);
        const float lj = __shfl_sync(0xffffffffu, p.y, j);
        if (e == 0.f) continue;                   // the same in every lane
        l = fmaf(e, lj, l);
        const float* a = ws_acc + ((size_t)(s0 + j) * rows + row) * dh + d0;
        if (vec4) {
          const float4 v = *reinterpret_cast<const float4*>(a);
          o[0] = fmaf(e, v.x, o[0]);
          o[1] = fmaf(e, v.y, o[1]);
          o[2] = fmaf(e, v.z, o[2]);
          o[3] = fmaf(e, v.w, o[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (d0 + k < dh) o[k] = fmaf(e, a[k], o[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (d0 + k < dh)
        out[(size_t)row * dh + d0 + k] = l > 0.f ? o[k] / l : 0.f;
  }
}

inline cudaError_t launch_combine(const Partials& w, float* out, int rows,
                                  int dh, int splits, cudaStream_t st) {
  const int blocks = (rows + kCombineWarps - 1) / kCombineWarps;
  combine_splits_kernel<<<blocks, kCombineWarps * 32, 0, st>>>(
      w.ml, w.acc, out, rows, dh, splits);
  return cudaGetLastError();
}

// Raise a kernel's dynamic shared-memory cap on the current device once
// per size it needs; `done` holds the cap set so far, one per device.
constexpr int kMaxDevices = 16;
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, size_t (&done)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = bytes;
  return err;
}

}  // namespace attn
