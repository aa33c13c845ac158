// Paged flash-decode attention for Hopper (sm_90a), the context split
// across blocks.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (`paged_attention`, pallas_call at :245, body `_kernel` at :119, index map
// `kv_block_index` at :68).  One query per decode slot attends its own pages
// of the position-aligned pool (P, ps, hkv, dh): key position t of slot b
// lives at page block_tables[b, t / ps], slot t % ps.  The gathered
// (B, nblk*ps, hkv, dh) context never exists in device memory.
//
// What bounds it: the K/V bytes of the live context, read once (about one
// operation per byte at rep = hq / hkv = 1, far below the H100's ~295), so
// the design is about bytes in flight and few instructions per byte:
// 1. Grid (slot x kv head, split).  The plan (kernels/index.py::
//    paged_attention_plan, from B, hkv, nblk, ps and the SM count) cuts
//    the table's positions into spans of whole 32-key tiles, so a long
//    context runs on many blocks at once instead of one block walking it
//    alone.  A split wholly past the slot's length or before its window
//    writes a neutral partial (l = 0) and exits.  Blocks of the last
//    splits (only long slots reach them) are dispatched first, so the
//    launch ends on the short ones.
// 2. Inside a block each warp streams its own 8-key steps (steps w, w + 4,
//    ... of the split; fewer keys a step for head dims above 256 in bf16
//    or 128 in f32) through a private three-stage cp.async ring, 16
//    bytes a lane (a key row of one head is contiguous: 256 bytes at
//    dh = 128 in bf16), with its own online softmax: no block barrier per
//    step, two steps in flight per warp.  Rows of freed (-1) pages and
//    past the span are zero-filled and masked.
// 3. Scores on CUDA cores: a group of lanes per key, each lane one or two
//    16-byte chunks of K against its chunks of q held in f32 registers,
//    then a shuffle reduction over the group (16 lanes and 4 steps at
//    dh = 128 in bf16).  Tensor cores would buy nothing at rep = 1.  GQA
//    rows go 4 at a time (one pass over the keys per 4 rows; rows of the
//    last pass past rep load q = 0 and write nothing), or one at a time
//    for rep = 1 and for head dims above 256 (bf16) / 128 (f32).  Shared
//    memory and registers depend on REPT and dh, not on rep.
// 4. PV: the lane that holds chunk c of q accumulates chunk c of its
//    group's keys' V rows; the groups, then the four warps (in warp order,
//    through shared memory), are summed at the end.
// 5. Each split writes its (m, l, acc) partial; combine_splits_kernel
//    (attention.cuh) sums them in split order, one warp per output row,
//    so a repeated call gives the same bits.  With one split the block
//    writes the output itself and nothing else is launched.
//
// Rules kept from the TPU kernel: table entries < 0 are skipped, rows with
// context_lens == 0 write zeros, scores are f32 scaled by 1/sqrt(dh) with an
// optional logit softcap, and the probabilities are cast to the V dtype
// before the PV product (the denominator uses the f32 values).  A
// probability is rounded relative to its warp's running max within its
// split.
#include "attention.cuh"

namespace {

using namespace attn;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
// Keys per warp step: 8 / CPL, fewer for long rows (CPL chunks a lane),
// so a warp's ring stays within 24 KB.

// Byte offsets of one block's shared memory: each warp's ring of kStages
// (K, V) steps of kKW rows of `ld` elements (dh rounded up to whole
// 16-byte chunks, zero past dh), their key flags, and the warps' partials
// for REPT rows (m, l, acc[ld]) summed at the end.
struct Layout {
  int ld;
  size_t ring, ok, part, total;
};

template <typename T, int REPT, int CPL>
__host__ __device__ inline Layout layout(int dh) {
  constexpr int kEpc = 16 / sizeof(T);
  constexpr int kKW = 8 / CPL;
  Layout L;
  L.ld = (dh + kEpc - 1) / kEpc * kEpc;
  L.ring = 0;
  size_t off = (size_t)kWarps * kStages * 2 * kKW * L.ld * sizeof(T);
  L.ok = off;
  off += (size_t)kWarps * kStages * kKW * sizeof(int);
  L.part = off;
  off += (size_t)kWarps * REPT * (L.ld + 2) * sizeof(float);
  L.total = off;
  return L;
}

// s += q . k over one 16-byte chunk of K, q in f32 registers.
__device__ __forceinline__ float dot_chunk(const __nv_bfloat16* k,
                                           const float (&q)[8], float s) {
  const uint4 uk = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* pk = reinterpret_cast<const __nv_bfloat162*>(&uk);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(pk[i]);
    s = fmaf(q[2 * i], a.x, s);
    s = fmaf(q[2 * i + 1], a.y, s);
  }
  return s;
}
__device__ __forceinline__ float dot_chunk(const float* k,
                                           const float (&q)[4], float s) {
  const float4 a = *reinterpret_cast<const float4*>(k);
  s = fmaf(q[0], a.x, s);
  s = fmaf(q[1], a.y, s);
  s = fmaf(q[2], a.z, s);
  return fmaf(q[3], a.w, s);
}

// acc[e] += p * v[e] over one 16-byte chunk of V.
__device__ __forceinline__ void pv_chunk(float (&acc)[8], float p,
                                         const __nv_bfloat16* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(v);
  const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(pv[i]);
    acc[2 * i] = fmaf(p, a.x, acc[2 * i]);
    acc[2 * i + 1] = fmaf(p, a.y, acc[2 * i + 1]);
  }
}
__device__ __forceinline__ void pv_chunk(float (&acc)[4], float p,
                                         const float* v) {
  const float4 a = *reinterpret_cast<const float4*>(v);
  acc[0] = fmaf(p, a.x, acc[0]);
  acc[1] = fmaf(p, a.y, acc[1]);
  acc[2] = fmaf(p, a.z, acc[2]);
  acc[3] = fmaf(p, a.w, acc[3]);
}

// REPT GQA rows per pass over the keys; CPL 16-byte chunks of a row per
// lane (the least power of two >= cpr / 32).
template <typename T, int REPT, int CPL>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       float* __restrict__ out, void* ws, int hq, int hkv,
                       int dh, int ps, int nblk, int window, float softcap,
                       float sm_scale, int span, int vec) {
  constexpr int kEpc = 16 / sizeof(T);           // elements per chunk
  constexpr int kKW = 8 / CPL;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = hq / hkv;
  const Layout L = layout<T, REPT, CPL>(dh);
  const int ld = L.ld;
  const int cpr = ld / kEpc;                     // chunks per row
  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int split = gridDim.y - 1 - blockIdx.y;   // the last splits, which
                                                 // only long slots fill, first
  const int splits = gridDim.y;
  const int rows = gridDim.x / hkv * hq;         // B * hq
  const int row0 = b * hq + h * rep;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Partials w(ws, splits, rows);
  const int length = context_lens[b];
  const int first = window > 0 ? max(length - window, 0) : 0;
  const int lo = max(split * span, first);
  const int hi = min(split * span + span, length);
  if (lo >= hi) {                                // no live key here
    if (splits == 1) {
      for (int i = tid; i < rep * dh; i += kThreads)
        out[(size_t)row0 * dh + i] = 0.f;
    } else {
      for (int r = tid; r < rep; r += kThreads)
        *w.ml_at(split, rows, row0 + r) = make_float2(kNegInf, 0.f);
    }
    return;
  }

  T* ring = reinterpret_cast<T*>(smem + L.ring)
            + (size_t)warp * kStages * 2 * kKW * ld;
  int* ok = reinterpret_cast<int*>(smem + L.ok) + warp * kStages * kKW;
  float* part = reinterpret_cast<float*>(smem + L.part);
  const int* bt = block_tables + (size_t)b * nblk;
  const Div pm(ps);
  const size_t pos_stride = (size_t)hkv * dh;
  // this warp's steps of the split: kKW keys each, steps warp, warp + 4..
  const int steps = (hi - lo + kKW - 1) / kKW;
  const int mine = steps > warp ? (steps - warp + kWarps - 1) / kWarps : 0;
  auto issue = [&](int t) {                      // the warp's t-th step
    const int st = t % kStages;
    const int p0 = lo + (warp + t * kWarps) * kKW;
    T* ks = ring + (size_t)st * 2 * kKW * ld;
    for (ChunkWalk cw(lane, 32, cpr); cw.j < kKW; cw.next()) {
      const int pos = p0 + cw.j;
      const T* kr = nullptr;
      const T* vr = nullptr;
      if (pos < hi) {
        const int page = bt[pm.quot(pos)];
        if (page >= 0) {
          const size_t off = ((size_t)page * ps + pm.rem(pos)) * pos_stride
                             + (size_t)h * dh;
          kr = k_pool + off;
          vr = v_pool + off;
        }
      }
      if (cw.c == 0) ok[st * kKW + cw.j] = kr != nullptr;
      copy_chunk(ks + cw.j * ld, kr, cw.c, dh, vec != 0, k_pool);
      copy_chunk(ks + (kKW + cw.j) * ld, vr, cw.c, dh, vec != 0, v_pool);
    }
  };

  // lanes: a group of lpk lanes per key (lpk the least power of two >=
  // cpr, at most 32); lane `part_` of its group holds chunks part_,
  // part_ + 32, ... (CPL of them)
  int lpk = 1;
  while (lpk < cpr && lpk < 32) lpk <<= 1;
  const int kpw = 32 / lpk;                      // keys per pass
  const int kg = lane / lpk;                     // this lane's key in a pass
  const int part_ = lane % lpk;

  for (int r0 = 0; r0 < rep; r0 += REPT) {       // one pass when rep <= REPT
    float qr[REPT][CPL][kEpc];
    float acc[REPT][CPL][kEpc];
    float m[REPT], l[REPT];
#pragma unroll
    for (int r = 0; r < REPT; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int u = 0; u < CPL; ++u)
#pragma unroll
        for (int e = 0; e < kEpc; ++e) {
          const int d = (part_ + u * 32) * kEpc + e;
          qr[r][u][e] = r0 + r < rep && d < dh
              ? to_float(q[(size_t)(row0 + r0 + r) * dh + d]) : 0.f;
          acc[r][u][e] = 0.f;
        }
    }
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < mine) issue(t);
      cp_async_commit();
    }
    for (int t = 0; t < mine; ++t) {
      if (t + kStages - 1 < mine) issue(t + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const int st = t % kStages;
      const T* ks = ring + (size_t)st * 2 * kKW * ld;
      const T* vs = ks + kKW * ld;
      // scores of the step's keys: pass p takes key p * kpw + kg
      float s[REPT][kKW];
#pragma unroll
      for (int p = 0; p < kKW; ++p) {
        const int k = p * kpw + kg;
        if (p * kpw >= kKW) break;               // the same in every lane
        const bool valid = k < kKW && ok[st * kKW + k] != 0;
        const T* krow = ks + (k < kKW ? k : 0) * ld;
#pragma unroll
        for (int r = 0; r < REPT; ++r) {
          float x = 0.f;
#pragma unroll
          for (int u = 0; u < CPL; ++u) {
            const int c = part_ + u * 32;
            if (c < cpr) x = dot_chunk(krow + c * kEpc, qr[r][u], x);
          }
          for (int o = lpk >> 1; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
          x *= sm_scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          s[r][p] = valid ? x : kNegInf;
        }
      }
      // online softmax over the warp's keys, then PV for this lane's key
#pragma unroll
      for (int r = 0; r < REPT; ++r) {
        float cmax = kNegInf;
#pragma unroll
        for (int p = 0; p < kKW; ++p)
          if (p * kpw < kKW) cmax = fmaxf(cmax, s[r][p]);
        for (int o = lpk; o < 32; o <<= 1)
          cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
        const float m_new = fmaxf(m[r], cmax);
        const float corr = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr;
#pragma unroll
        for (int u = 0; u < CPL; ++u)
#pragma unroll
          for (int e = 0; e < kEpc; ++e) acc[r][u][e] *= corr;
#pragma unroll
        for (int p = 0; p < kKW; ++p) {
          const int k = p * kpw + kg;
          if (p * kpw >= kKW) break;
          const float pr = s[r][p] > 0.5f * kNegInf ? expf(s[r][p] - m_new)
                                                    : 0.f;
          l[r] += pr;
          if (k < kKW) {
            const float pv = round_to(pr, v_pool);
#pragma unroll
            for (int u = 0; u < CPL; ++u) {
              const int c = part_ + u * 32;
              if (c < cpr) pv_chunk(acc[r][u], pv, vs + k * ld + c * kEpc);
            }
          }
        }
      }
      __syncwarp();                              // the stage may be refilled
    }
    cp_async_wait<0>();
    // sum the key groups of the warp (same lane part_ in every group); a
    // lane's l counts its group's keys once
#pragma unroll
    for (int r = 0; r < REPT; ++r)
      for (int o = lpk; o < 32; o <<= 1) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
        for (int u = 0; u < CPL; ++u)
#pragma unroll
          for (int e = 0; e < kEpc; ++e)
            acc[r][u][e] += __shfl_xor_sync(0xffffffffu, acc[r][u][e], o);
      }
    // the warps' partials, then their sum in warp order
#pragma unroll
    for (int r = 0; r < REPT; ++r) {
      float* pw = part + ((size_t)warp * REPT + r) * (ld + 2);
      if (lane == 0) {
        pw[0] = m[r];
        pw[1] = l[r];
      }
      if (lane < lpk) {
#pragma unroll
        for (int u = 0; u < CPL; ++u) {
          const int c = part_ + u * 32;
          if (c < cpr) {
#pragma unroll
            for (int e = 0; e < kEpc; ++e) pw[2 + c * kEpc + e] = acc[r][u][e];
          }
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < REPT * dh; i += kThreads) {
      const int r = i / dh;
      const int d = i % dh;
      if (r0 + r >= rep) break;
      float m_max = kNegInf;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const float* pw = part + ((size_t)v * REPT + r) * (ld + 2);
        if (pw[1] > 0.f) m_max = fmaxf(m_max, pw[0]);
      }
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const float* pw = part + ((size_t)v * REPT + r) * (ld + 2);
        if (pw[1] > 0.f) {
          const float e = expf(pw[0] - m_max);
          lsum = fmaf(e, pw[1], lsum);
          a = fmaf(e, pw[2 + d], a);
        }
      }
      const size_t row = (size_t)row0 + r0 + r;
      if (splits == 1) {
        out[row * dh + d] = lsum > 0.f ? a / lsum : 0.f;
      } else {
        w.acc[((size_t)split * rows + row) * dh + d] = a;
        if (d == 0) *w.ml_at(split, rows, row) = make_float2(m_max, lsum);
      }
    }
    __syncthreads();                             // before the next pass
  }
}

template <typename T, int REPT, int CPL>
size_t g_smem_set[kMaxDevices];

// One launch (the split kernel, then the combine when there are splits).
struct Launch {
  const void *q, *k_pool, *v_pool, *block_tables, *context_lens;
  void *out, *ws;
  int B, hq, hkv, dh, ps, nblk, window;
  float softcap, sm_scale;
  int span, splits, vec;
  cudaStream_t st;

  template <typename T, int REPT, int CPL>
  cudaError_t run() const {
    const Layout L = layout<T, REPT, CPL>(dh);
    auto kern = paged_attention_kernel<T, REPT, CPL>;
    cudaError_t err = allow_smem(kern, L.total, g_smem_set<T, REPT, CPL>);
    if (err != cudaSuccess) return err;
    kern<<<dim3(B * hkv, splits), kThreads, L.total, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
        static_cast<const int*>(context_lens), static_cast<float*>(out), ws,
        hq, hkv, dh, ps, nblk, window, softcap, sm_scale, span, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return err;
    return launch_combine(Partials(ws, splits, B * hq),
                          static_cast<float*>(out), B * hq, dh, splits, st);
  }
};

// The blocks of one instance an SM holds at once.
struct Occupancy {
  int dh;
  int* blocks;

  template <typename T, int REPT, int CPL>
  cudaError_t run() const {
    const Layout L = layout<T, REPT, CPL>(dh);
    auto kern = paged_attention_kernel<T, REPT, CPL>;
    cudaError_t err = allow_smem(kern, L.total, g_smem_set<T, REPT, CPL>);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                         kThreads, L.total);
  }
};

// f.run on the instance for this group size and head dim: 4 GQA rows a
// pass when rep > 1 and a lane holds at most 2 chunks, else 1; CPL chunks
// a lane.
template <typename T, typename F>
cudaError_t dispatch(int rep, int dh, const F& f) {
  constexpr int kEpc = 16 / sizeof(T);
  const int cpl = (dh + 32 * kEpc - 1) / (32 * kEpc);
  if (rep > 1 && cpl <= 2)
    return cpl == 1 ? f.template run<T, 4, 1>() : f.template run<T, 4, 2>();
  switch (cpl) {
    case 1: return f.template run<T, 1, 1>();
    case 2: return f.template run<T, 1, 2>();
    case 3: case 4: return f.template run<T, 1, 4>();
    default: return f.template run<T, 1, 8>();
  }
}

}  // namespace

// q (B, hq, dh); k_pool, v_pool (P, ps, hkv, dh) of one layer, all of dtype
// bf16 (is_bf16 = 1) or f32; block_tables (B, nblk) int32; context_lens (B,)
// int32; out (B, hq, dh) f32; ws the f32 split workspace (attention.cuh
// Partials, index.SplitPlan.ws_floats; unused for one split).  window <= 0
// means none; softcap <= 0 means none.  span and splits: the plan
// (index.paged_attention_plan).  vec = 1 when dh * element size is a
// multiple of 16 and every operand 16-byte aligned.  Any group size: a
// block takes its rep rows REPT at a time (rep 10 at REPT 4 is three
// passes over the keys, the last with two live rows).
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* block_tables,
                                      const void* context_lens, void* out,
                                      void* ws, int B, int hq, int hkv,
                                      int dh, int ps, int nblk, int window,
                                      float softcap, float sm_scale, int span,
                                      int splits, int vec, int is_bf16,
                                      void* stream) {
  const Launch f{q, k_pool, v_pool, block_tables, context_lens, out, ws, B,
                 hq, hkv, dh, ps, nblk, window, softcap, sm_scale, span,
                 splits, vec, static_cast<cudaStream_t>(stream)};
  const int rep = hq / hkv;
  return static_cast<int>(is_bf16 ? dispatch<__nv_bfloat16>(rep, dh, f)
                                  : dispatch<float>(rep, dh, f));
}

// Blocks of the decode kernel one SM of the current device holds at once,
// for GQA group size rep and head dim dh.
extern "C" int paged_attention_occupancy(int is_bf16, int rep, int dh,
                                         int* blocks) {
  const Occupancy f{dh, blocks};
  return static_cast<int>(is_bf16 ? dispatch<__nv_bfloat16>(rep, dh, f)
                                  : dispatch<float>(rep, dh, f));
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
