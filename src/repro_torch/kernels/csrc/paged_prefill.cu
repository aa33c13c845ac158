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
// start and length are read from a device int32 pair when `meta` is given
// (no host sync), else taken from the scalar arguments.
//
// bf16 (the serving path): paged_prefill_tc_kernel.  What bounds it at the
// serving shape (C = 64, LLaMA-7B) is latency, not bytes or operations:
// 4-7 MB and 0.3 GFLOP a call.  So:
// 1. Both products on the tensor cores, mma.sync m16n8k16 bf16 -> f32.  A kv
//    head's query rows are (chunk row, head in group) flattened, so one
//    16-row mma tile covers GQA groups too; a block holds 64 rows (4 warps).
//    S = Q K^T takes K rows by ldmatrix, P goes into PV as bf16 (the
//    reference's p.astype(v.dtype)) straight from the S registers, V by
//    ldmatrix.trans.  Head dims pad with zeros to 64, 128 or 256 in shared
//    memory (exact: zero q lanes add nothing; padded columns are never
//    stored).
// 2. Keys split across blocks: grid (kv head, row tile, split), split i
//    taking key positions [i * span, (i + 1) * span) of the context plus
//    chunk (kernels/index.py::paged_prefill_plan, from C, nblk, ps, hkv and
//    the SM count, never from start).  A split past the tile's last key
//    writes a neutral partial; combine_splits_kernel (attention.cuh) sums
//    the partials in split order, one warp per output row.  With one split
//    the blocks write the output themselves and nothing else is launched.
// 3. K/V tiles through a two-stage cp.async ring, 16 bytes a thread (a key
//    row of one head is contiguous); rows of shared memory padded by 16
//    bytes so ldmatrix reads 8 rows from 8 bank groups.
// 4. The scatter: chunk page cp of kv head h belongs to exactly one block,
//    the (cp mod n)-th from the end of the head's n = row tiles x splits
//    blocks (the last splits are the ones most often empty), copied with
//    16-byte stores.  In-chunk keys come from k_new / v_new and the context
//    pages are other table entries than the pages written, so no block
//    reads what another block of the launch writes.
//
// f32 (small-model checks on the card, which hold it to 1e-4, beyond bf16
// tensor cores): paged_prefill_f32_kernel, CUDA-core f32 over the whole
// key range in one block per (kv head, query tile), as the port's first
// version did; it shares the scatter.
//
// Numerics follow the TPU kernel: f32 scores scaled by 1/sqrt(dh), optional
// softcap, probabilities cast to the V dtype for the PV product (with a
// split, relative to its split's running max), f32 denominator and
// accumulator.
#include "attention.cuh"

namespace {

using namespace attn;
using bf16 = __nv_bfloat16;

// Copy chunk page cp of kv head h (ps rows of dh) from k_new / v_new into
// pool page `page`, by 16-byte stores when vec.
template <typename T>
__device__ void scatter_page(T* kl, T* vl, const T* k_new, const T* v_new,
                             int page, int cp, int h, int hkv, int dh, int ps,
                             bool vec) {
  if (vec) {
    const int cpr = dh * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < ps * cpr; i += blockDim.x) {
      const int s = i / cpr;
      const int c = i % cpr;
      const size_t src = ((size_t)(cp * ps + s) * hkv + h) * dh;
      const size_t dst = (((size_t)page * ps + s) * hkv + h) * dh;
      reinterpret_cast<uint4*>(kl + dst)[c] =
          reinterpret_cast<const uint4*>(k_new + src)[c];
      reinterpret_cast<uint4*>(vl + dst)[c] =
          reinterpret_cast<const uint4*>(v_new + src)[c];
    }
  } else {
    for (int i = threadIdx.x; i < ps * dh; i += blockDim.x) {
      const int s = i / dh;
      const int d = i % dh;
      const size_t src = ((size_t)(cp * ps + s) * hkv + h) * dh + d;
      const size_t dst = (((size_t)page * ps + s) * hkv + h) * dh + d;
      kl[dst] = k_new[src];
      vl[dst] = v_new[src];
    }
  }
}

// The pool page chunk page cp is written to, or -1 when the write is
// masked (past length, or a shared block).
__device__ __forceinline__ int chunk_page(const int* bt_write, int start,
                                          int length, int cp, int ps,
                                          int nblk) {
  const int blk = min(max(start / ps + cp, 0), nblk - 1);
  const int page = bt_write[blk];
  return (cp * ps < length && page >= 0) ? page : -1;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles, keys split across blocks
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 128;
constexpr int kTcRows = 64;              // query rows per block (index.PREFILL_ROWS)

template <int DHP>
struct Tc {
  static constexpr int KT = DHP <= 128 ? 64 : 32;  // index.prefill_key_tile
  static constexpr int LD = DHP + 8;               // padded row, elements
  static constexpr int Q_ELEMS = kTcRows * LD;
  static constexpr int TILE_ELEMS = KT * LD;
  static constexpr size_t SMEM =
      (size_t)(Q_ELEMS + 4 * TILE_ELEMS) * sizeof(bf16)  // q, 2 x (K, V)
      + 2 * KT * sizeof(int);                            // key validity
};

template <int DHP>
__global__ void __launch_bounds__(kTcThreads)
paged_prefill_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k_new,
                        const bf16* __restrict__ v_new,
                        bf16* __restrict__ k_pool, bf16* __restrict__ v_pool,
                        const int* __restrict__ bt_read,
                        const int* __restrict__ bt_write,
                        const int* __restrict__ meta, int start_h,
                        int length_h, float* __restrict__ out, void* ws,
                        int C, int hq, int hkv, int dh, int ps, int nblk,
                        int pool_pages, int layer, int window, float softcap,
                        float sm_scale, int span, int vec) {
  using Cfg = Tc<DHP>;
  constexpr int KT = Cfg::KT;
  constexpr int LD = Cfg::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);      // [kTcRows][LD]
  bf16* k_s = q_s + Cfg::Q_ELEMS;                 // [stage][KT][LD]
  bf16* v_s = k_s + 2 * Cfg::TILE_ELEMS;
  int* ok_s = reinterpret_cast<int*>(v_s + 2 * Cfg::TILE_ELEMS);  // [stage][KT]

  const int h = blockIdx.x;
  const int rt = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rep = hq / hkv;
  const int start = meta ? meta[0] : start_h;
  const int length = meta ? meta[1] : length_h;
  const size_t layer_stride = (size_t)pool_pages * ps * hkv * dh;
  bf16* kl = k_pool + (size_t)layer * layer_stride;
  bf16* vl = v_pool + (size_t)layer * layer_stride;

  // ---- the scatter: one block per (chunk page, kv head) ----------------
  const int per_head = gridDim.y * splits;
  const int me = rt * splits + split;
  for (int cp = 0; cp < C / ps; ++cp) {
    if (per_head - 1 - cp % per_head != me) continue;
    const int page = chunk_page(bt_write, start, length, cp, ps, nblk);
    if (page >= 0)
      scatter_page(kl, vl, k_new, v_new, page, cp, h, hkv, dh, ps, vec != 0);
  }

  // ---- this block's rows and keys (index.prefill_split_keys) -----------
  const int rows_h = C * rep;                      // query rows of head h
  const int rows = C * hq;                         // rows of out
  const int r_lo = rt * kTcRows;
  const Partials w(ws, splits, rows);
  // row i of this tile (i < nrows) is (chunk row, head in group)
  const int nrows = min(kTcRows, rows_h - r_lo);
  const Div grp(rep);
  auto row_of = [&](int i) {
    const int gi = r_lo + i;
    return (size_t)grp.quot(gi) * hq + h * rep + grp.rem(gi);
  };
  const int c_lo = r_lo / rep;
  const int c_hi = min((r_lo + kTcRows - 1) / rep, C - 1);
  const int first = window > 0 ? max(start + c_lo + 1 - window, 0) : 0;
  const int lo = max(split * span, first);
  const int hi = min(split * span + span, start + min(c_hi + 1, length));
  if (lo >= hi) {                                  // no key of the tile here
    for (int i = tid; i < nrows; i += kTcThreads) {
      if (splits == 1) {
        for (int d = 0; d < dh; ++d) out[row_of(i) * dh + d] = 0.f;
      } else {
        *w.ml_at(split, rows, row_of(i)) = make_float2(kNegInf, 0.f);
      }
    }
    return;
  }

  if (dh < DHP || !vec) {                          // zero the padding once
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n = (Cfg::Q_ELEMS + 4 * Cfg::TILE_ELEMS) * sizeof(bf16) / 16;
    for (int i = tid; i < n; i += kTcThreads) z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  const int cpr = (dh + 7) / 8;                    // 16-byte chunks of a row
  for (ChunkWalk cw(tid, kTcThreads, cpr); cw.j < kTcRows; cw.next()) {
    const int gi = r_lo + cw.j;
    const bf16* src = gi < rows_h ? q + row_of(cw.j) * dh : nullptr;
    copy_chunk(q_s + cw.j * LD, src, cw.c, dh, vec != 0, q);
  }
  const Div pm(ps);
  const size_t pos_stride = (size_t)hkv * dh;
  auto issue = [&](int t0, int st) {
    for (ChunkWalk cw(tid, kTcThreads, cpr); cw.j < KT; cw.next()) {
      const int pos = t0 + cw.j;
      const bf16* ks = nullptr;
      const bf16* vs = nullptr;
      if (pos < hi) {
        if (pos < start) {
          const int blk = pm.quot(pos);
          const int page = blk < nblk ? bt_read[blk] : -1;
          if (page >= 0) {
            const size_t off = ((size_t)page * ps + pm.rem(pos)) * pos_stride
                               + (size_t)h * dh;
            ks = kl + off;
            vs = vl + off;
          }
        } else {
          const size_t off = (size_t)(pos - start) * pos_stride
                             + (size_t)h * dh;
          ks = k_new + off;
          vs = v_new + off;
        }
      }
      if (cw.c == 0) ok_s[st * KT + cw.j] = ks != nullptr;
      const size_t row = ((size_t)st * KT + cw.j) * LD;
      copy_chunk(k_s + row, ks, cw.c, dh, vec != 0, k_new);
      copy_chunk(v_s + row, vs, cw.c, dh, vec != 0, v_new);
    }
  };

  // rows g and g + 8 of this warp's 16-row mma tile
  const int g = lane >> 2;
  const int t4 = lane & 3;
  int qp[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    qp[hh] = start + (r_lo + warp * 16 + g + hh * 8) / rep;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float o[DHP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DHP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  const bf16* qw = q_s + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int ntiles = (hi - lo + KT - 1) / KT;
  issue(lo, 0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    const int t0 = lo + t * KT;
    if (t + 1 < ntiles) {
      issue(t0 + KT, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = k_s + (size_t)st * Cfg::TILE_ELEMS;
    const bf16* vs = v_s + (size_t)st * Cfg::TILE_ELEMS;
    // -- S = Q K^T ------------------------------------------------------
    float s[KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    // the fragments of a k-step are loaded before its mma's, so the
    // loads overlap and the mma's issue back to back
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      uint32_t a[4];
      uint32_t b[KT / 16][4];
      ldmatrix_x4(a, qw + kk * 16);
#pragma unroll
      for (int np = 0; np < KT / 16; ++np)
        ldmatrix_x4(b[np], ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD
                               + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < KT / 16; ++np) {
        mma_bf16(s[2 * np], a, b[np][0], b[np][1]);
        mma_bf16(s[2 * np + 1], a, b[np][2], b[np][3]);
      }
    }
    // -- scale, softcap, mask; online softmax per row ----------------------
    // the tile's live keys as bits; row hh sees keys jmin[hh] .. jmax[hh]
    const uint32_t ok_lo = __ballot_sync(0xffffffffu,
                                         ok_s[st * KT + lane] != 0);
    const uint32_t ok_hi = KT > 32 ? __ballot_sync(
        0xffffffffu, ok_s[st * KT + (KT > 32 ? 32 + lane : lane)] != 0) : 0u;
    int jmin[2], jmax[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      jmax[hh] = qp[hh] - t0;
      jmin[hh] = window > 0 ? qp[hh] - window + 1 - t0 : 0;
    }
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int j = nt * 8 + 2 * t4 + (e & 1);
        const uint32_t bits = nt < 4 ? ok_lo : ok_hi;
        float v = s[nt][e] * sm_scale;
        if (softcap > 0.f) v = softcap * tanhf(v / softcap);
        const bool ok = ((bits >> (j & 31)) & 1u) && j <= jmax[hh]
                        && j >= jmin[hh];
        s[nt][e] = ok ? v : kNegInf;
        tmax[hh] = fmaxf(tmax[hh], s[nt][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
      const float m_new = fmaxf(m[hh], tmax[hh]);
      corr[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= corr[hh];
    }
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const float p = s[nt][e] > 0.5f * kNegInf ? expf(s[nt][e] - m[hh])
                                                  : 0.f;
        l[hh] += p;
        s[nt][e] = p;
      }
    }
#pragma unroll
    for (int nd = 0; nd < DHP / 8; ++nd) {
      o[nd][0] *= corr[0];
      o[nd][1] *= corr[0];
      o[nd][2] *= corr[1];
      o[nd][3] *= corr[1];
    }
    // -- O += P V (P rounded to bf16) --------------------------------------
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n0 = 0; n0 < DHP / 8; n0 += 8) {        // 4 loads, 8 mma's
        uint32_t b[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          ldmatrix_x4_trans(
              b[u], vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                        + (n0 + 2 * u) * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          mma_bf16(o[n0 + 2 * u], a, b[u][0], b[u][1]);
          mma_bf16(o[n0 + 2 * u + 1], a, b[u][2], b[u][3]);
        }
      }
    }
    __syncthreads();
  }

  // ---- the partial (or, with one split, the output) ----------------------
  // Each warp stages its 16 x DHP f32 tile in the (now idle) K/V ring and
  // writes it out a row at a time with 16-byte stores.
  float* stage = reinterpret_cast<float*>(k_s) + warp * 16 * (DHP + 8);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const float den = splits == 1 ? fmaxf(l[hh], 1e-30f) : 1.f;
    float* srow = stage + (g + hh * 8) * (DHP + 8) + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < DHP / 8; ++nd)
      *reinterpret_cast<float2*>(srow + nd * 8) =
          make_float2(o[nd][2 * hh] / den, o[nd][2 * hh + 1] / den);
    const int i = warp * 16 + g + hh * 8;
    if (splits > 1 && t4 == 0 && i < nrows)
      *w.ml_at(split, rows, row_of(i)) = make_float2(m[hh], l[hh]);
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int i = warp * 16 + r;
    if (i >= nrows) break;
    const size_t row = row_of(i);
    float* dst = splits == 1 ? out + row * dh
                             : w.acc + ((size_t)split * rows + row) * dh;
    const float* src = stage + r * (DHP + 8);
    if (dh % 4 == 0) {
      for (int d = lane * 4; d < dh; d += 128)
        *reinterpret_cast<float4*>(dst + d) =
            *reinterpret_cast<const float4*>(src + d);
    } else {
      for (int d = lane; d < dh; d += 32) dst[d] = src[d];
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, one block per (kv head, query tile)
// ---------------------------------------------------------------------------
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;       // query-head rows per block
constexpr int kKT = 64;         // key positions per tile
constexpr int kMaxD = 2;        // dh / kThreads head dims per thread

__host__ __device__ inline size_t smem_floats(int dh) {
  return (size_t)kRows * dh            // q
         + (size_t)kKT * (dh + 1)      // k (padded rows: no bank conflicts)
         + (size_t)kKT * dh            // v
         + (size_t)kRows * kKT         // scores / probabilities
         + 3 * kRows                   // m, l, corr
         + kKT;                        // key validity
}

__global__ void __launch_bounds__(kThreads)
paged_prefill_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k_new,
                         const float* __restrict__ v_new,
                         float* __restrict__ k_pool,
                         float* __restrict__ v_pool,
                         const int* __restrict__ bt_read,
                         const int* __restrict__ bt_write,
                         const int* __restrict__ meta, int start_h,
                         int length_h, float* __restrict__ out, int C, int hq,
                         int hkv, int dh, int ps, int nblk, int pool_pages,
                         int layer, int q_per_tile, int window, float softcap,
                         float sm_scale, int vec) {
  extern __shared__ __align__(16) float fsmem[];
  const int rep = hq / hkv;
  const int rows = q_per_tile * rep;
  float* q_s = fsmem;
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
  float* kl = k_pool + (size_t)layer * layer_stride;
  float* vl = v_pool + (size_t)layer * layer_stride;

  // ---- the scatter: chunk page cp belongs to query tile cp % tiles -----
  for (int cp = qt; cp < C / ps; cp += gridDim.y) {
    const int page = chunk_page(bt_write, start, length, cp, ps, nblk);
    if (page >= 0)
      scatter_page(kl, vl, k_new, v_new, page, cp, h, hkv, dh, ps, vec != 0);
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



size_t g_tc_smem_set[3][kMaxDevices];
size_t g_f32_smem_set[kMaxDevices];

template <int DHP>
cudaError_t launch_tc(int slot, const void* q, const void* k_new,
                      const void* v_new, void* k_pool, void* v_pool,
                      const int* bt_read, const int* bt_write,
                      const int* meta, int start_h, int length_h, float* out,
                      void* ws, int C, int hq, int hkv, int dh, int ps,
                      int nblk, int pool_pages, int layer, int window,
                      float softcap, float sm_scale, int row_tiles,
                      int splits, int span, int vec, cudaStream_t st) {
  auto kern = paged_prefill_tc_kernel<DHP>;
  cudaError_t err = allow_smem(kern, Tc<DHP>::SMEM, g_tc_smem_set[slot]);
  if (err != cudaSuccess) return err;
  kern<<<dim3(hkv, row_tiles, splits), kTcThreads, Tc<DHP>::SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<bf16*>(k_pool),
      static_cast<bf16*>(v_pool), bt_read, bt_write, meta, start_h, length_h,
      out, ws, C, hq, hkv, dh, ps, nblk, pool_pages, layer, window, softcap,
      sm_scale, span, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_combine(Partials(ws, splits, C * hq), out, C * hq, dh,
                        splits, st);
}

template <int DHP>
cudaError_t occupancy_tc(int slot, int* blocks) {
  auto kern = paged_prefill_tc_kernel<DHP>;
  cudaError_t err = allow_smem(kern, Tc<DHP>::SMEM, g_tc_smem_set[slot]);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, kTcThreads, Tc<DHP>::SMEM);
}

}  // namespace

// q (C, hq, dh); k_new, v_new (C, hkv, dh); k_pool, v_pool
// (L, pool_pages, ps, hkv, dh) updated in place at `layer`; all of dtype bf16
// (is_bf16 = 1) or f32.  bt_read, bt_write (nblk,) int32.  meta: device
// int32 [start, length] or null (then start_h, length_h).  out (C, hq, dh)
// f32.  bf16: row_tiles, splits and span are the plan
// (index.paged_prefill_plan) and ws its f32 split workspace (attention.cuh
// Partials, index.SplitPlan.ws_floats; null for one split); f32 ignores
// them.  vec = 1
// when dh * element size is a multiple of 16 and every operand is 16-byte
// aligned.  Requires C % ps == 0, hq % hkv == 0, dh <= 256, and for f32
// hq / hkv <= 16.
extern "C" int paged_prefill_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* bt_read, const void* bt_write, const void* meta,
    int start_h, int length_h, void* out, void* ws, int C, int hq, int hkv,
    int dh, int ps, int nblk, int pool_pages, int layer, int window,
    float softcap, float sm_scale, int row_tiles, int splits, int span,
    int vec, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* btr = static_cast<const int*>(bt_read);
  const int* btw = static_cast<const int*>(bt_write);
  const int* mt = static_cast<const int*>(meta);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (is_bf16) {
#define REPRO_TC(DHP, SLOT)                                                   \
    launch_tc<DHP>(SLOT, q, k_new, v_new, k_pool, v_pool, btr, btw, mt,       \
                   start_h, length_h, o, ws, C, hq, hkv, dh, ps, nblk,         \
                   pool_pages, layer, window, softcap, sm_scale, row_tiles,   \
                   splits, span, vec, st)
    err = dh <= 64 ? REPRO_TC(64, 0) : dh <= 128 ? REPRO_TC(128, 1)
                                                 : REPRO_TC(256, 2);
#undef REPRO_TC
  } else {
    const int q_per_tile = kRows / (hq / hkv);
    const size_t smem = smem_floats(dh) * sizeof(float);
    auto kern = paged_prefill_f32_kernel;
    err = allow_smem(kern, smem, g_f32_smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(hkv, (C + q_per_tile - 1) / q_per_tile), kThreads, smem,
           st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_new),
        static_cast<const float*>(v_new), static_cast<float*>(k_pool),
        static_cast<float*>(v_pool), btr, btw, mt, start_h, length_h, o, C,
        hq, hkv, dh, ps, nblk, pool_pages, layer, q_per_tile, window,
        softcap, sm_scale, vec);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

// Blocks of the bf16 kernel for head dim dh that one SM of the current
// device holds at once.
extern "C" int paged_prefill_occupancy(int dh, int* blocks) {
  const cudaError_t err = dh <= 64 ? occupancy_tc<64>(0, blocks)
                          : dh <= 128 ? occupancy_tc<128>(1, blocks)
                                      : occupancy_tc<256>(2, blocks);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
