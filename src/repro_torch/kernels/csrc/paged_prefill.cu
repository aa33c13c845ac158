// Fused scatter + attend chunked prefill over the paged KV pool, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_prefill.py
// (`paged_prefill`, pallas_call at :258, body `_kernel` at :84, index map
// `ctx_block_index` at :66).  One launch advances ONE request's prefill by a
// chunk of C tokens:
//   * it writes the chunk's K/V into the request's pool pages in place (the
//     TPU kernel's input_output_aliases): chunk page cp goes to
//     bt_write[start / ps + cp] when cp * ps < length and that entry is >= 0;
//     masked writes are skipped, so the dump page is never touched;
//   * it runs causal flash attention of the chunk's queries over the context
//     pages (bt_read, positions < start) and then over the in-chunk keys,
//     which it takes from k_new / v_new and never from the pool.
//
// Grid: (hkv, query tiles).  A block owns one kv head and a tile of up to
// kRows query-head rows; it streams key tiles of kKT positions through
// shared memory with an online softmax.  Chunk page cp of kv head h is
// written by exactly one block, the one with tile index cp % gridDim.y.
// Because in-chunk keys come from k_new / v_new and the context pages are
// other table entries than the pages being written, no block reads what
// another block of the same launch writes.
//
// start and length are read from a device int32 pair when `meta` is given
// (no host sync), else taken from the scalar arguments.
//
// What bounds it: the context K/V bytes read once per kv head plus the chunk
// pages written; at long contexts the score and PV products (run here on
// CUDA cores in f32; tensor-core tiles are later work).
//
// Numerics follow the TPU kernel: f32 scores scaled by 1/sqrt(dh), optional
// softcap, probabilities cast to the V dtype for the PV product, f32
// denominator and accumulator.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;       // query-head rows per block
constexpr int kKT = 64;         // key positions per tile
constexpr int kMaxD = 2;        // dh / kThreads head dims per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

__host__ __device__ inline size_t smem_floats(int dh) {
  return (size_t)kRows * dh            // q
         + (size_t)kKT * (dh + 1)      // k (padded rows: no bank conflicts)
         + (size_t)kKT * dh            // v
         + (size_t)kRows * kKT         // scores / probabilities
         + 3 * kRows                   // m, l, corr
         + kKT;                        // key validity
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                     const T* __restrict__ v_new, T* __restrict__ k_pool,
                     T* __restrict__ v_pool, const int* __restrict__ bt_read,
                     const int* __restrict__ bt_write,
                     const int* __restrict__ meta, int start_h, int length_h,
                     float* __restrict__ out, int C, int hq, int hkv, int dh,
                     int ps, int nblk, int pool_pages, int layer,
                     int q_per_tile, int window, float softcap,
                     float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int rep = hq / hkv;
  const int rows = q_per_tile * rep;
  float* q_s = smem;
  float* k_s = q_s + kRows * dh;
  float* v_s = k_s + kKT * (dh + 1);
  float* sc = v_s + kKT * dh;
  float* m_s = sc + kRows * kKT;
  float* l_s = m_s + kRows;
  float* corr_s = l_s + kRows;
  float* kval = corr_s + kRows;

  const int h = blockIdx.x;
  const int qt = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = meta ? meta[0] : start_h;
  const int length = meta ? meta[1] : length_h;
  const size_t layer_stride = (size_t)pool_pages * ps * hkv * dh;
  T* kl = k_pool + (size_t)layer * layer_stride;
  T* vl = v_pool + (size_t)layer * layer_stride;

  // ---- fused scatter: this block's share of the chunk pages ----------
  const int n_chunk_pages = C / ps;
  for (int cp = qt; cp < n_chunk_pages; cp += gridDim.y) {
    const int blk = min(max(start / ps + cp, 0), nblk - 1);
    const int page = bt_write[blk];
    if (cp * ps < length && page >= 0) {
      for (int i = tid; i < ps * dh; i += kThreads) {
        const int s = i / dh;
        const int d = i % dh;
        const size_t src = ((size_t)(cp * ps + s) * hkv + h) * dh + d;
        const size_t dst = (((size_t)page * ps + s) * hkv + h) * dh + d;
        kl[dst] = k_new[src];
        vl[dst] = v_new[src];
      }
    }
  }

  // ---- queries of this tile: row i = (chunk row c, head r) -----------
  const int c_lo = qt * q_per_tile;
  for (int i = tid; i < kRows * dh; i += kThreads) {
    const int row = i / dh;
    const int d = i % dh;
    const int c = c_lo + row / rep;
    const int r = row % rep;
    q_s[i] = (row < rows && c < C)
        ? to_float(q[((size_t)c * hq + (size_t)h * rep + r) * dh + d]) : 0.f;
  }
  for (int i = tid; i < kRows; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  float acc[kRows][kMaxD];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kMaxD; ++j) acc[i][j] = 0.f;

  const int c_hi = min(c_lo + q_per_tile, C) - 1;   // last chunk row here
  // context keys below the oldest query's window are invisible to the tile
  const int ctx_first = window > 0 ? max(start + c_lo + 1 - window, 0) : 0;
  const int n_ctx_tiles = start > ctx_first
      ? (start - ctx_first + kKT - 1) / kKT : 0;
  const int n_new = min(c_hi + 1, length);           // in-chunk keys needed
  const int n_new_tiles = (max(n_new, 0) + kKT - 1) / kKT;

  for (int t = 0; t < n_ctx_tiles + n_new_tiles; ++t) {
    const bool is_ctx = t < n_ctx_tiles;
    const int t0 = is_ctx ? ctx_first + t * kKT : (t - n_ctx_tiles) * kKT;
    __syncthreads();
    // -- stage the key tile (K padded rows, V plain rows) --------------
    if (tid < kKT) {
      bool ok;
      if (is_ctx) {
        const int pos = t0 + tid;
        ok = pos < start && bt_read[min(pos / ps, nblk - 1)] >= 0;
      } else {
        ok = t0 + tid < n_new;
      }
      kval[tid] = ok ? 1.f : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kKT * dh; i += kThreads) {
      const int j = i / dh;
      const int d = i % dh;
      float kv = 0.f, vv = 0.f;
      if (kval[j] != 0.f) {
        size_t off;
        if (is_ctx) {
          const int pos = t0 + j;
          const int page = bt_read[pos / ps];
          off = (((size_t)page * ps + pos % ps) * hkv + h) * dh + d;
          kv = to_float(kl[off]);
          vv = to_float(vl[off]);
        } else {
          off = ((size_t)(t0 + j) * hkv + h) * dh + d;
          kv = to_float(k_new[off]);
          vv = to_float(v_new[off]);
        }
      }
      k_s[j * (dh + 1) + d] = kv;
      v_s[j * dh + d] = vv;
    }
    __syncthreads();
    // -- scores: thread -> key j = tid % kKT, rows tid / kKT + 2k --------
    {
      const int j = tid % kKT;
      const int kp = is_ctx ? t0 + j : start + t0 + j;   // key position
      for (int row = tid / kKT; row < kRows; row += kThreads / kKT) {
        float s = 0.f;
        for (int d = 0; d < dh; ++d)
          s = fmaf(q_s[row * dh + d], k_s[j * (dh + 1) + d], s);
        s *= sm_scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int c = c_lo + row / rep;
        const int qp = start + c;
        bool valid = kval[j] != 0.f && row < rows && c < C;
        if (!is_ctx) valid = valid && kp <= qp;
        if (window > 0) valid = valid && qp - kp < window;
        sc[row * kKT + j] = valid ? s : kNegInf;
      }
    }
    __syncthreads();
    // -- online softmax: one warp per row, 2 keys per lane ---------------
    for (int row = warp; row < kRows; row += kWarps) {
      const float s0 = sc[row * kKT + lane];
      const float s1 = sc[row * kKT + lane + 32];
      const bool v0 = s0 > 0.5f * kNegInf;
      const bool v1 = s1 > 0.5f * kNegInf;
      float tmax = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, tmax);
      const float p0 = v0 ? expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.f;
      float psum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      sc[row * kKT + lane] = round_to(p0, v_new);
      sc[row * kKT + lane + 32] = round_to(p1, v_new);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[row] = corr;
        l_s[row] = l_s[row] * corr + psum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();
    // -- PV: thread owns head dims d = tid + kThreads * jd for all rows --
#pragma unroll
    for (int jd = 0; jd < kMaxD; ++jd) {
      const int d = tid + jd * kThreads;
      if (d < dh) {
#pragma unroll
        for (int row = 0; row < kRows; ++row) acc[row][jd] *= corr_s[row];
        for (int j = 0; j < kKT; ++j) {
          const float vv = v_s[j * dh + d];
#pragma unroll
          for (int row = 0; row < kRows; ++row)
            acc[row][jd] = fmaf(sc[row * kKT + j], vv, acc[row][jd]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int jd = 0; jd < kMaxD; ++jd) {
    const int d = tid + jd * kThreads;
    if (d < dh) {
#pragma unroll
      for (int row = 0; row < kRows; ++row) {
        const int c = c_lo + row / rep;
        if (row < rows && c < C) {
          const int r = row % rep;
          out[((size_t)c * hq + (size_t)h * rep + r) * dh + d] =
              acc[row][jd] / fmaxf(l_s[row], 1e-30f);
        }
      }
    }
  }
}

}  // namespace

// q (C, hq, dh); k_new, v_new (C, hkv, dh); k_pool, v_pool
// (L, pool_pages, ps, hkv, dh) updated in place at `layer`; all of dtype bf16
// (is_bf16 = 1) or f32.  bt_read, bt_write (nblk,) int32.  meta: device
// int32 [start, length] or null (then start_h, length_h).  out (C, hq, dh)
// f32.  Requires C % ps == 0, hq % hkv == 0, hq / hkv <= 16, dh <= 256.
extern "C" int paged_prefill_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* bt_read, const void* bt_write, const void* meta,
    int start_h, int length_h, void* out, int C, int hq, int hkv, int dh,
    int ps, int nblk, int pool_pages, int layer, int window, float softcap,
    float sm_scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = hq / hkv;
  const int q_per_tile = kRows / rep;
  dim3 grid(hkv, (C + q_per_tile - 1) / q_per_tile);
  const size_t smem = smem_floats(dh) * sizeof(float);
  if (is_bf16) {
    using T = __nv_bfloat16;
    auto kern = paged_prefill_kernel<T>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_new),
        static_cast<const T*>(v_new), static_cast<T*>(k_pool),
        static_cast<T*>(v_pool), static_cast<const int*>(bt_read),
        static_cast<const int*>(bt_write), static_cast<const int*>(meta),
        start_h, length_h, static_cast<float*>(out), C, hq, hkv, dh, ps,
        nblk, pool_pages, layer, q_per_tile, window, softcap, sm_scale);
  } else {
    using T = float;
    auto kern = paged_prefill_kernel<T>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_new),
        static_cast<const T*>(v_new), static_cast<T*>(k_pool),
        static_cast<T*>(v_pool), static_cast<const int*>(bt_read),
        static_cast<const int*>(bt_write), static_cast<const int*>(meta),
        start_h, length_h, static_cast<float*>(out), C, hq, hkv, dh, ps,
        nblk, pool_pages, layer, q_per_tile, window, softcap, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
