// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (`paged_attention`, pallas_call at :245, body `_kernel` at :119, index map
// `kv_block_index` at :68).  One query per decode slot attends its own pages
// of the position-aligned pool (P, ps, hkv, dh): key position t of slot b
// lives at page block_tables[b, t / ps], slot t % ps.  The gathered
// (B, nblk*ps, hkv, dh) context never exists in device memory.
//
// On the TPU the page axis is a sequential grid dimension carrying (m, l, acc)
// scratch between steps.  Here one block owns one (slot, kv head) pair and
// loops over its live keys in tiles of kKT positions, carrying the online-
// softmax state in shared memory and registers; blocks share nothing.  Each
// block reads its own block-table entries.  The loop starts at the sliding-
// window start and stops at the slot's context length, so the K/V bytes read
// follow the live context.
//
// Rules kept from the TPU kernel: table entries < 0 are skipped, rows with
// context_lens == 0 write zeros, scores are f32 scaled by 1/sqrt(dh) with an
// optional logit softcap, and the probabilities are cast to the V dtype
// before the PV product (the running denominator uses the f32 values).
//
// What bounds it: the K/V bytes of the live context (2 * len * dh * 2 bytes
// per kv head in bf16), read once.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKT = 64;         // key positions per tile
constexpr int kMaxOut = 8;      // (rep * dh) / kThreads outputs per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

// floats before the 8-byte key offsets, rounded up to keep them aligned
__host__ __device__ inline size_t smem_floats(int rep, int dh) {
  const size_t n = (size_t)rep * dh + (size_t)rep * kKT + 3 * (size_t)rep;
  return n + (n & 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       float* __restrict__ out, int hq, int hkv, int dh,
                       int ps, int nblk, int window, float softcap,
                       float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rep = hq / hkv;
  float* q_s = reinterpret_cast<float*>(smem_raw);          // [rep][dh]
  float* sc = q_s + rep * dh;                               // [rep][kKT]
  float* m_s = sc + rep * kKT;                              // [rep]
  float* l_s = m_s + rep;                                   // [rep]
  float* corr_s = l_s + rep;                                // [rep]
  long long* koff = reinterpret_cast<long long*>(
      q_s + smem_floats(rep, dh));                          // [kKT]

  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_out = rep * dh;
  float* o_base = out + ((size_t)b * hq + (size_t)h * rep) * dh;
  const int length = context_lens[b];
  if (length <= 0) {
    for (int i = tid; i < n_out; i += kThreads) o_base[i] = 0.f;
    return;
  }
  const T* q_base = q + ((size_t)b * hq + (size_t)h * rep) * dh;
  for (int i = tid; i < n_out; i += kThreads) q_s[i] = to_float(q_base[i]);
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;

  const int first = window > 0 ? max(length - window, 0) : 0;
  const int* bt = block_tables + (size_t)b * nblk;
  for (int t0 = first; t0 < length; t0 += kKT) {
    __syncthreads();
    if (tid < kKT) {
      const int pos = t0 + tid;
      long long off = -1;
      if (pos < length) {
        const int page = bt[pos / ps];
        if (page >= 0)
          off = (((long long)page * ps + pos % ps) * hkv + h) * dh;
      }
      koff[tid] = off;
    }
    __syncthreads();
    // scores: warp w takes keys w, w + kWarps, ...; lanes split dh
    for (int j = warp; j < kKT; j += kWarps) {
      const long long off = koff[j];
      for (int r = 0; r < rep; ++r) {
        float part = 0.f;
        if (off >= 0) {
          for (int d = lane; d < dh; d += 32)
            part = fmaf(q_s[r * dh + d], to_float(k_pool[off + d]), part);
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, s);
        if (lane == 0) {
          float s = part * sm_scale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          sc[r * kKT + j] = off >= 0 ? s : kNegInf;
        }
      }
    }
    __syncthreads();
    // online-softmax update: one warp per query row, 2 keys per lane
    for (int r = warp; r < rep; r += kWarps) {
      const float s0 = sc[r * kKT + lane];
      const float s1 = sc[r * kKT + lane + 32];
      const bool v0 = koff[lane] >= 0;
      const bool v1 = koff[lane + 32] >= 0;
      float tmax = fmaxf(v0 ? s0 : kNegInf, v1 ? s1 : kNegInf);
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, s));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      const float p0 = v0 ? expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.f;
      float psum = p0 + p1;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, s);
      sc[r * kKT + lane] = round_to(p0, v_pool);
      sc[r * kKT + lane + 32] = round_to(p1, v_pool);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // PV: thread owns outputs i = tid + kThreads * j, i = r * dh + d
#pragma unroll
    for (int jo = 0; jo < kMaxOut; ++jo) {
      const int i = tid + jo * kThreads;
      if (i < n_out) {
        const int r = i / dh;
        const int d = i % dh;
        float a = acc[jo] * corr_s[r];
        for (int j = 0; j < kKT; ++j) {
          const long long off = koff[j];
          if (off >= 0) a = fmaf(sc[r * kKT + j], to_float(v_pool[off + d]), a);
        }
        acc[jo] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int jo = 0; jo < kMaxOut; ++jo) {
    const int i = tid + jo * kThreads;
    if (i < n_out) o_base[i] = acc[jo] / fmaxf(l_s[i / dh], 1e-30f);
  }
}

size_t smem_bytes(int rep, int dh) {
  return smem_floats(rep, dh) * sizeof(float) + kKT * sizeof(long long);
}

}  // namespace

// q (B, hq, dh); k_pool, v_pool (P, ps, hkv, dh) of one layer, all of dtype
// bf16 (is_bf16 = 1) or f32; block_tables (B, nblk) int32; context_lens (B,)
// int32; out (B, hq, dh) f32.  window <= 0 means none; softcap <= 0 means
// none.  Requires rep * dh <= 1024.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* block_tables,
                                      const void* context_lens, void* out,
                                      int B, int hq, int hkv, int dh, int ps,
                                      int nblk, int window, float softcap,
                                      float sm_scale, int is_bf16,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = hq / hkv;
  const size_t smem = smem_bytes(rep, dh);
  dim3 grid(B * hkv);
  if (is_bf16) {
    auto kern = paged_attention_kernel<__nv_bfloat16>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool),
        static_cast<const int*>(block_tables),
        static_cast<const int*>(context_lens), static_cast<float*>(out), hq,
        hkv, dh, ps, nblk, window, softcap, sm_scale);
  } else {
    auto kern = paged_attention_kernel<float>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool),
        static_cast<const int*>(block_tables),
        static_cast<const int*>(context_lens), static_cast<float*>(out), hq,
        hkv, dh, ps, nblk, window, softcap, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
