// The packed PTQ1.61 matmuls for Hopper (sm_90a), one kernel body:
//
//   mixed:   y = x_s @ ((q - z) * s)  +  ((x_b * a_r2) @ sign) * (a_s * a_r1)
//   binary:  y = ((x * a_in) @ sign) * a_out        (the int4 span empty)
//   int4:    y = x @ ((q - z) * s)                  (the binary span empty)
//
// Replaces the Pallas TPU kernels src/repro/kernels/mixed_matmul.py
// (`mixed_matmul`, pallas_call at :158, and its in-kernel-gather variant at
// :166), src/repro/kernels/binary_matmul.py (`binary_matmul`, :75) and
// src/repro/kernels/int4_matmul.py (`int4_matmul`, :61).  The activation x
// arrives in its original channel order and is gathered by `perm`; with
// perm == nullptr x is taken as already salient-first.
//
// What bounds it: at decode (M = 1..8) the packed weight bytes (0.5 per
// int4 weight, 0.125 per sign), which a launch streams once; at M = 64
// (prefill chunks) the tensor-core operations, 2*M*K*N.  The design, point
// by point against what held the CUDA-core version back:
//
// 1. Products on the tensor cores: mma.sync m16n8k16 bf16 -> f32.  The
//    weight tile is the A operand (16 output columns x 16 channels),
//    dequantized in registers: nibbles become bf16((q - z) * s) computed
//    in f32, sign bits become bf16 +-1 by a byte permute and a mask.  The
//    activations are the B operand (8 rows, ldmatrix), so M <= 8 fills
//    n = 8.
// 2. Enough blocks at decode: K is split across blocks (grid.y) by the plan
//    of index.py::packed_matmul_plan, which fills one wave of resident
//    blocks (the SMs times the blocks an SM holds, which
//    packed_matmul_occupancy asks the runtime for; up to 16 splits).
//    Splits fall on 16-channel k-steps of each span (packed-byte
//    boundaries).  Each split writes its int4 and binary f32
//    partial sums to a workspace; fold_kernel then sums them in split
//    order, scales the binary sum by a_s * a_r1 and rounds once to bf16,
//    so two calls give the same bits.
// 3. An asynchronous pipeline: 16-byte cp.async copies of packed weight
//    rows, activation tiles and per-channel (s, z) into a ring of 4 stages
//    in dynamic shared memory, three stages in flight while one is used.
// 4. One block covers up to 64 rows (8 mma n-tiles), so every packed byte
//    is read and unpacked once per launch for M <= 64; each dequantized A
//    fragment feeds all of the block's n-tiles.
// 5. x is gathered by perm once per launch, by gather_kernel, into a bf16
//    workspace laid out [row][channel] salient-first: binary channels
//    scaled by a_r2 and rounded to bf16 there, each span zero-padded to a
//    whole k-step, so ragged tails need no loop of their own.  Blocks copy
//    their tiles of it into shared memory (rows padded by 16 bytes against
//    bank conflicts).  A gather inside every block would repeat it once
//    per column tile (96 times for the fused QKV) with 2-byte loads; on an
//    H100 that cost more than the products at M = 64 (PERF.md).
// 6. The host side: the launch plan is computed once per shape in Python
//    and passed here unchanged with every pointer in one argument; the
//    workspaces are allocated once per device and stream
//    (kernels/mixed_matmul.py).
//
// Numerics follow the TPU kernels: bf16 operands, int4 weights dequantized
// in f32 and rounded to bf16, x_b * a_r2 in f32 rounded to bf16, f32
// accumulation, one bf16 rounding of the output.  Only the order of the
// sums differs.  On request the output is that f32 accumulator before its
// rounding (the epilogue and fold_kernel write f32 instead of bf16): a
// row-parallel product sums such partials over its ranks and rounds once.
// Shapes: any M and N; k_s even; k_b a multiple of 8.  x's rows may be
// wider than K (a row-parallel view of a leaf gathers its channels from
// the whole activation by its own perm): ldx is their stride.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;              // 4 warps side by side in N
constexpr int kKStep = 16;                 // index.py PACKED_KSTEP
constexpr int kMaxSplits = 16;             // index.py PACKED_MAX_SPLITS
constexpr int kStages = 4;                 // ring depth

// NT 8-row mma n-tiles (rows) by MT = 2 16-column m-tiles per warp: a
// warp owns 32 columns and every row of the block, so each dequantized A
// fragment feeds NT products and each B fragment two.
constexpr int MT = 2;
constexpr int kBN = 4 * 16 * MT;           // index.py PACKED_BN
constexpr int kWStride = kBN + 32;         // bytes per staged weight row

template <int NT>
struct Cfg {
  static constexpr int R = 8 * NT;                     // rows per block
  static constexpr int CH4 = 64;                       // int4 ch./stage
  static constexpr int CHB = NT == 1 ? 256 : 512 / NT; // binary ch./stage
  static constexpr int XSTRIDE = CHB + 8;              // bf16 per x row
  static constexpr int WROWS = CH4 / 2;                // = CHB / 8 or more
  static constexpr int WBYTES = WROWS * kWStride;
  static constexpr int XBYTES = R * XSTRIDE * 2;
  static constexpr int SZBYTES = 2 * CH4 * 4;          // s then z
  static constexpr int STAGE = WBYTES + XBYTES + SZBYTES;
  static constexpr int SMEM = kStages * STAGE;
  static_assert(CHB / 8 <= WROWS, "a binary stage must fit the slot");
};

struct Params {
  const uint8_t* w4;         // (k_s/2, N)
  const float* s4;           // (k_s,)
  const float* z4;
  const uint8_t* bits;       // (k_b/8, N)
  const float* alpha_s;      // (N,): the output scale
  const float* alpha_r1;     // (N,) or null (taken as 1)
  const __nv_bfloat16* xg;   // (M, kp) gathered x, kp = 16 * (n4 + nb)
  __nv_bfloat16* y;          // (M, N) bf16 output
  float* yf;                 // (M, N) f32 output instead, or null
  float* ws;                 // (splits, 2, M, N) partial sums
  int M, N, k_s, k_b, kp, vec;
};

struct Splits {
  int n4, nb, count;
  int b[kMaxSplits + 1];
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two int4 channels (low nibble = even channel) of column c of a word of
// 4 columns, as a bf16 pair, each bf16((q - z) * s) from f32: lo and hi
// hold the word's low and high nibbles, one per byte.
__device__ __forceinline__ uint32_t dequant2(uint32_t lo, uint32_t hi, int c,
                                             float2 s, float2 z) {
  // 2^23 + q, exact, then q
  const float q0 = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7440 | c))
                   - 8388608.f;
  const float q1 = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7440 | c))
                   - 8388608.f;
  return pack_bf16((q0 - z.x) * s.x, (q1 - z.y) * s.y);
}

// Two sign channels of column c of a word of 4 columns as a bf16 pair of
// +-1: u0 and u1 hold the two channels' bits in bit 7 of each byte.
__device__ __forceinline__ uint32_t signs2(uint32_t u0, uint32_t u1, int c) {
  const uint32_t sel = (c << 4) | ((4 + c) << 12);
  return (__byte_perm(u0, u1, sel) & 0x80008000u) ^ 0xBF80BF80u;
}

// x gathered by perm into xg (M, kp) bf16: channel pc < p4 is int4 channel
// pc, the rest binary channel pc - p4 scaled by a_r2; zero past each
// span's end.  x's rows are ldx apart (K, or wider under a local perm).
// One thread per pair of channels.
__global__ void __launch_bounds__(256)
gather_kernel(const unsigned short* __restrict__ x,
              const int* __restrict__ perm,
              const float* __restrict__ alpha_r2, uint32_t* __restrict__ xg,
              int M, int K, int k_s, int p4, int kp, int ldx) {
  const int half = kp / 2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * half) return;
  const int row = static_cast<int>(idx / half);
  const int pc = 2 * static_cast<int>(idx % half);
  const bool bin = pc >= p4;
  const int c = bin ? pc - p4 : pc;
  uint32_t v = 0;
  if (c < (bin ? K - k_s : k_s)) {        // c even, span ends even
    const int kg = (bin ? k_s : 0) + c;
    const int s0 = perm ? __ldg(perm + kg) : kg;
    const int s1 = perm ? __ldg(perm + kg + 1) : kg + 1;
    const unsigned short* xr = x + (size_t)row * ldx;
    const uint32_t lo = __ldg(xr + s0), hi = __ldg(xr + s1);
    if (bin) {
      v = pack_bf16(__uint_as_float(lo << 16) * __ldg(alpha_r2 + c),
                    __uint_as_float(hi << 16) * __ldg(alpha_r2 + c + 1));
    } else {
      v = lo | (hi << 16);
    }
  }
  xg[idx] = v;
}

// y from the partial sums of every split, in split order: the int4 sums,
// plus the binary sums times a_s * a_r1, rounded to bf16 into y, or kept
// f32 into yf when it is given.  One thread per 4 columns; the loads of 8
// splits are issued before they are summed.
__global__ void __launch_bounds__(64)
fold_kernel(const float* __restrict__ ws, const float* __restrict__ alpha_s,
            const float* __restrict__ alpha_r1, __nv_bfloat16* __restrict__ y,
            float* __restrict__ yf, int M, int N, const Splits sp) {
  constexpr int kBatch = 8;
  const int nq = (N + 3) / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * nq) return;
  const int row = static_cast<int>(idx / nq);
  const int col = 4 * static_cast<int>(idx % nq);
  const int nc = min(4, N - col);
  const size_t MN = (size_t)M * N;
  const size_t o = (size_t)row * N + col;
  float y4[4] = {0.f, 0.f, 0.f, 0.f}, yb[4] = {0.f, 0.f, 0.f, 0.f};
  if ((N & 3) == 0) {
    for (int i0 = 0; i0 < sp.count; i0 += kBatch) {
      float4 v[kBatch][2];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u;
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const bool has = i < sp.count && (part == 0 ? sp.b[i] < sp.n4
                                                       : sp.b[i + 1] > sp.n4);
          v[u][part] = has ? __ldcg(reinterpret_cast<const float4*>(
                                 ws + (size_t)(2 * i + part) * MN + o))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (i0 + u >= sp.count) break;
        y4[0] += v[u][0].x; y4[1] += v[u][0].y;
        y4[2] += v[u][0].z; y4[3] += v[u][0].w;
        yb[0] += v[u][1].x; yb[1] += v[u][1].y;
        yb[2] += v[u][1].z; yb[3] += v[u][1].w;
      }
    }
  } else {
    for (int i = 0; i < sp.count; ++i) {
      for (int c = 0; c < nc; ++c) {
        if (sp.b[i] < sp.n4) y4[c] += __ldcg(ws + (size_t)(2 * i) * MN + o + c);
        if (sp.b[i + 1] > sp.n4) {
          yb[c] += __ldcg(ws + (size_t)(2 * i + 1) * MN + o + c);
        }
      }
    }
  }
  for (int c = 0; c < nc; ++c) {
    float v = y4[c];
    if (sp.nb > 0) {
      v += yb[c] * (alpha_s[col + c] * (alpha_r1 ? alpha_r1[col + c] : 1.f));
    }
    if (yf) {
      yf[o + c] = v;
    } else {
      y[o + c] = __float2bfloat16_rn(v);
    }
  }
}

// One stage of one span within a block's split: channels [c0, c1) of the
// span, span-relative.
struct Stage {
  int c0, c1;
};

template <int NT>
struct Body {
  using C = Cfg<NT>;
  const Params& p;
  uint8_t* ring;
  int tid, lane, warp, g, t, n0, row0, p4;
  int a4, e4, ab, eb, S4, ns;

  template <bool BIN>
  __device__ Stage stage(int s) const {
    if constexpr (!BIN) {
      const int c0 = a4 + s * C::CH4;
      return {c0, min(c0 + C::CH4, e4)};
    } else {
      const int c0 = ab + (s - S4) * C::CHB;
      return {c0, min(c0 + C::CHB, eb)};
    }
  }

  __device__ uint8_t* wslot(int s) const {
    return ring + (s % kStages) * C::STAGE;
  }
  __device__ __nv_bfloat16* xslot(int s) const {
    return reinterpret_cast<__nv_bfloat16*>(wslot(s) + C::WBYTES);
  }
  __device__ float* szslot(int s) const {
    return reinterpret_cast<float*>(wslot(s) + C::WBYTES + C::XBYTES);
  }

  // Issue the copies of stage s into ring slot s % kStages: its packed
  // rows (rows past the span's end zero-filled), its x tile and, for
  // int4, its (s, z).  Trip counts are compile-time constants.
  template <bool BIN>
  __device__ void load_stage_span(int s) const {
    const Stage st = stage<BIN>(s);
    constexpr int SH = BIN ? 3 : 1;                    // channels per byte
    constexpr int CH = BIN ? C::CHB : C::CH4;
    const int valid = (st.c1 - st.c0 + (1 << SH) - 1) >> SH;
    const uint8_t* src = (BIN ? p.bits : p.w4) + (size_t)(st.c0 >> SH) * p.N
                         + n0;
    uint8_t* dst = wslot(s);
    constexpr int KC = kBN / 16;                     // chunks per row
    if (p.vec) {
#pragma unroll
      for (int i = 0; i < C::WROWS * KC / kThreads; ++i) {
        const int id = tid + i * kThreads;
        const int r = id / KC, q = id % KC;
        const bool ok = r < valid && n0 + 16 * q < p.N;
        cp_async16(dst + r * kWStride + 16 * q,
                   ok ? src + r * p.N + 16 * q : src, ok ? 16 : 0);
      }
    } else {
      for (int id = tid; id < C::WROWS * kBN; id += kThreads) {
        const int r = id / kBN, c = id % kBN;
        dst[r * kWStride + c] =
            (r < valid && n0 + c < p.N) ? src[r * p.N + c] : 0;
      }
    }
    // x: rows row0.., gathered channels pc0.. of the stage (16-byte chunks
    // past the row's end zero-filled; a zero-filled copy still writes)
    constexpr int XC = CH / 8;
    const int pc0 = (BIN ? p4 : 0) + st.c0;
    __nv_bfloat16* xs = xslot(s);
#pragma unroll
    for (int i = 0; i < (C::R * XC + kThreads - 1) / kThreads; ++i) {
      const int id = tid + i * kThreads;
      if (C::R * XC % kThreads != 0 && id >= C::R * XC) break;
      const int r = id / XC, q = id % XC;
      const bool ok = row0 + r < p.M && pc0 + 8 * q < p.kp;
      cp_async16(xs + r * C::XSTRIDE + 8 * q,
                 ok ? p.xg + (size_t)(row0 + r) * p.kp + pc0 + 8 * q : p.xg,
                 ok ? 16 : 0);
    }
    if constexpr (!BIN) {
#pragma unroll
      for (int i = 0; i < 2 * C::CH4 / kThreads; ++i) {
        const int id = tid + i * kThreads;
        const int c = st.c0 + id % C::CH4;
        const bool ok = c < st.c1;
        const float* v = id < C::CH4 ? p.s4 : p.z4;
        cp_async4(szslot(s) + id, ok ? v + c : v, ok ? 4 : 0);
      }
    }
  }

  __device__ void load_stage(int s) const {
    if (s < S4) {
      load_stage_span<false>(s);
    } else {
      load_stage_span<true>(s);
    }
  }

  // B fragments of n-tiles j (and j+1) at k-step ks by ldmatrix: lane l
  // addresses row (l & 7) of matrix l >> 3 = (n-tile, channel half).
  __device__ void load_b(const __nv_bfloat16* xs, int ks,
                         uint32_t (&b)[NT][2]) const {
    if constexpr (NT == 1) {
      const __nv_bfloat16* ptr = xs + (lane & 7) * C::XSTRIDE + 16 * ks
                                 + 8 * ((lane >> 3) & 1);
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                   : "=r"(b[0][0]), "=r"(b[0][1]) : "r"(smem_addr(ptr)));
    } else {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int q = lane >> 3;
        const __nv_bfloat16* ptr = xs + (8 * (j + (q >> 1)) + (lane & 7))
                                   * C::XSTRIDE + 16 * ks + 8 * (q & 1);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(b[j][0]), "=r"(b[j][1]), "=r"(b[j + 1][0]),
              "=r"(b[j + 1][1])
            : "r"(smem_addr(ptr)));
      }
    }
  }

  // The k-steps of stage s (one span), unrolled so that the loads and the
  // unpacking of later k-steps overlap the mma chain.  Byte c of this
  // lane's word of a staged row is column 4g + c of the warp's: A rows g
  // and g + 8 of m-tile m are its columns 2m and 2m + 1.
  template <bool BIN>
  __device__ void compute_span(int s, float (&acc)[MT][NT][4]) const {
    const Stage st = stage<BIN>(s);
    constexpr int KMAX = (BIN ? C::CHB : C::CH4) / kKStep;
    const uint8_t* w = wslot(s) + warp * 32 + 4 * g;
    const __nv_bfloat16* xs = xslot(s);
    const float* sv = szslot(s) + 2 * t;
    const float* zv = sv + C::CH4;
    const int ksteps = (st.c1 - st.c0 + kKStep - 1) / kKStep;
#pragma unroll
    for (int ks = 0; ks < KMAX; ++ks) {
      if (ks >= ksteps) break;
      uint32_t a[MT][4];
      if constexpr (BIN) {
        // channels 2t, 2t+1 in row 2ks; 2t+8, 2t+9 in row 2ks+1
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
            w + (2 * ks) * kWStride);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
            w + (2 * ks + 1) * kWStride);
        const uint32_t u0 = w0 << (7 - 2 * t), u1 = w0 << (6 - 2 * t);
        const uint32_t v0 = w1 << (7 - 2 * t), v1 = w1 << (6 - 2 * t);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          a[m][0] = signs2(u0, u1, 2 * m);
          a[m][1] = signs2(u0, u1, 2 * m + 1);
          a[m][2] = signs2(v0, v1, 2 * m);
          a[m][3] = signs2(v0, v1, 2 * m + 1);
        }
      } else {
        // channels 2t, 2t+1 in row 8ks+t; 2t+8, 2t+9 in row 8ks+t+4
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
            w + (8 * ks + t) * kWStride);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
            w + (8 * ks + t + 4) * kWStride);
        // (s, z) of those channels (zero past the span)
        const float2 s0 = *reinterpret_cast<const float2*>(sv + 16 * ks);
        const float2 s8 = *reinterpret_cast<const float2*>(sv + 16 * ks + 8);
        const float2 z0 = *reinterpret_cast<const float2*>(zv + 16 * ks);
        const float2 z8 = *reinterpret_cast<const float2*>(zv + 16 * ks + 8);
        const uint32_t l0 = w0 & 0x0F0F0F0Fu, h0 = (w0 >> 4) & 0x0F0F0F0Fu;
        const uint32_t l1 = w1 & 0x0F0F0F0Fu, h1 = (w1 >> 4) & 0x0F0F0F0Fu;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          a[m][0] = dequant2(l0, h0, 2 * m, s0, z0);
          a[m][1] = dequant2(l0, h0, 2 * m + 1, s0, z0);
          a[m][2] = dequant2(l1, h1, 2 * m, s8, z8);
          a[m][3] = dequant2(l1, h1, 2 * m + 1, s8, z8);
        }
      }
      uint32_t b[NT][2];
      load_b(xs, ks, b);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(acc[m][j], a[m], b[j][0], b[j][1]);
      }
    }
  }

  __device__ void compute(int s, float (&acc)[MT][NT][4]) const {
    if (s < S4) {
      compute_span<false>(s, acc);
    } else {
      compute_span<true>(s, acc);
    }
  }
};

// Grid (column tiles, splits, row groups); 128 threads.  Warp w owns
// columns n0 + 32w .. n0 + 32w + 31: lane (g = lane/4, t = lane%4) holds,
// in m-tile m, A rows g and g+8 = columns 4g + 2m and 4g + 2m + 1 of the
// warp's, and the outputs of those columns at rows 2t, 2t+1 of each
// n-tile.  With one split the block writes y (bf16, or with F32 the
// accumulator as f32 into yf); with more it writes its partial sums and
// fold_kernel sums them.  The bf16 instantiations are the F32-free code.
template <int NT, bool F32>
__global__ void __launch_bounds__(kThreads)
packed_matmul_kernel(const Params p, const Splits sp) {
  using C = Cfg<NT>;
  extern __shared__ __align__(16) uint8_t smem[];
  Body<NT> b{p, smem};
  const int tid = threadIdx.x;
  b.tid = tid;
  b.lane = tid & 31;
  b.warp = tid >> 5;
  b.g = b.lane >> 2;
  b.t = b.lane & 3;
  b.n0 = blockIdx.x * kBN;
  b.row0 = blockIdx.z * C::R;
  b.p4 = kKStep * sp.n4;
  const int split = blockIdx.y;
  const int lo = sp.b[split], hi = sp.b[split + 1];
  b.a4 = min(lo, sp.n4) * kKStep;
  b.e4 = min(min(hi, sp.n4) * kKStep, p.k_s);
  b.ab = max(lo - sp.n4, 0) * kKStep;
  b.eb = min(max(hi - sp.n4, 0) * kKStep, p.k_b);
  const bool has4 = b.e4 > b.a4, hasb = b.eb > b.ab;
  b.S4 = has4 ? (b.e4 - b.a4 + C::CH4 - 1) / C::CH4 : 0;
  b.ns = b.S4 + (hasb ? (b.eb - b.ab + C::CHB - 1) / C::CHB : 0);

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  // this lane's outputs: columns colw .. colw + 3 at rows 2t, 2t+1 of
  // each n-tile; acc[m][j][e] is column colw + 2m + (e >> 1) at row
  // 8j + 2t + (e & 1)
  constexpr int NC = 2 * MT;
  const int colw = b.n0 + b.warp * 32 + NC * b.g;
  const bool vec4 = (p.N & 3) == 0;
  const size_t MN = (size_t)p.M * p.N;
  float* const part0 = p.ws + (size_t)(2 * split) * MN;
  // write acc as partial sum `part` of this split (f32, (M, N))
  auto write_part = [&](int part) {
    float* base = part0 + part * MN;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = b.row0 + 8 * j + 2 * b.t + rr;
        if (row >= p.M) continue;
        float* out = base + (size_t)row * p.N + colw;
        const float v[NC] = {acc[0][j][rr], acc[0][j][2 + rr], acc[1][j][rr],
                             acc[1][j][2 + rr]};
        if (vec4 && colw + 3 < p.N) {
          *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (colw + c < p.N) out[c] = v[c];
        }
      }
    }
  };

  // ---- pipeline: copies kStages - 1 stages ahead ----
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < b.ns) b.load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < b.ns; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < b.ns) b.load_stage(s + kStages - 1);
    cp_async_commit();
    b.compute(s, acc);
    if (s == b.S4 - 1 && hasb) {   // the int4 sum is done: set it aside
      write_part(0);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: acc holds the binary sum if the split has a binary
  // span, else its int4 sum; with both, the int4 sum is in part 0.  With
  // more than one split, fold_kernel sums the parts ----
  if (gridDim.y > 1) {
    write_part(hasb ? 1 : 0);
    return;
  }
  float a[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    a[c] = hasb && colw + c < p.N
        ? p.alpha_s[colw + c] * (p.alpha_r1 ? p.alpha_r1[colw + c] : 1.f)
        : 0.f;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = b.row0 + 8 * j + 2 * b.t + rr;
      if (row >= p.M) continue;
      float v[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float r = acc[c >> 1][j][((c & 1) << 1) + rr];
        if (!hasb) {
          v[c] = r;
        } else {
          const float i4 = has4 && colw + c < p.N
              ? part0[(size_t)row * p.N + colw + c] : 0.f;
          v[c] = i4 + r * a[c];
        }
      }
      if constexpr (F32) {
        float* out = p.yf + (size_t)row * p.N + colw;
        if (vec4 && colw + 3 < p.N) {
          *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (colw + c < p.N) out[c] = v[c];
        }
        continue;
      }
      __nv_bfloat16* out = p.y + (size_t)row * p.N + colw;
      if (vec4 && colw + 3 < p.N) {
        const uint2 u = {pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])};
        *reinterpret_cast<uint2*>(out) = u;
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (colw + c < p.N) out[c] = __float2bfloat16_rn(v[c]);
      }
    }
  }
}

// Allow packed_matmul_kernel<NT, F32> its dynamic shared memory (above
// the 48 KB default), once per device.
template <int NT, bool F32>
cudaError_t prepare() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(packed_matmul_kernel<NT, F32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<NT>::SMEM);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

template <int NT>
cudaError_t launch_nt(const Params& p, const Splits& sp, dim3 grid,
                      cudaStream_t stream) {
  // the unsplit epilogue writes the output; split blocks write partials
  const bool f32 = p.yf != nullptr && sp.count == 1;
  cudaError_t err = f32 ? prepare<NT, true>() : prepare<NT, false>();
  if (err != cudaSuccess) return err;
  if (f32) {
    packed_matmul_kernel<NT, true>
        <<<grid, kThreads, Cfg<NT>::SMEM, stream>>>(p, sp);
  } else {
    packed_matmul_kernel<NT, false>
        <<<grid, kThreads, Cfg<NT>::SMEM, stream>>>(p, sp);
  }
  return cudaGetLastError();
}

template <int NT>
cudaError_t occupancy(int* blocks) {
  cudaError_t err = prepare<NT, false>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, packed_matmul_kernel<NT, false>, kThreads, Cfg<NT>::SMEM);
}

}  // namespace

// One launch (the gather, the matmul, and the fold when K is split) from
// one run of 64-bit words in native byte order (a single argument keeps
// the host's call short):
//   a[0..11]  pointers x, perm, w4, s4, z4, bits, alpha_s, alpha_r1,
//             alpha_r2, y, ws, xg;
//   a[12]     the CUDA stream;
//   a[13]     ldx, the stride of x's rows (K, or more with a perm);
//   a[14]     1 for an f32 y (the accumulator before its rounding), else 0;
//   a[15..18] M, N, K, k_s;
//   a[19..]   the plan of index.py::packed_matmul_plan: nt, row_groups,
//             col_tiles, n4, nb, splits, then the splits + 1 bounds.
// x (M, ldx) bf16 contiguous, ldx = K without perm; perm (K,) int32 of
// channels below ldx, or null; w4 (k_s/2, N) u8, low
// nibble = even channel (null when k_s = 0); s4, z4 (k_s,) f32; bits
// (k_b/8, N) u8, bit j of byte i = channel 8i+j (null when k_b = 0);
// alpha_s (N,) f32, the output scale of the binary sum (null when k_b = 0);
// alpha_r1 (N,) f32 or null (taken as 1); alpha_r2 (k_b,) f32; y (M, N)
// bf16 (f32 with a[14]); ws: f32 workspace of the plan's ws_floats; xg: bf16 workspace of
// the plan's xg_elems.  Launches on the stream and returns
// cudaGetLastError().
extern "C" int packed_matmul_launch(const char* words) {
  constexpr int kHead = 25;                // a[0..24]: up to the splits
  long long a[kHead + kMaxSplits + 1];
  memcpy(a, words, kHead * sizeof(long long));
  if (a[24] < 1 || a[24] > kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  memcpy(a + kHead, words + kHead * sizeof(long long),
         (a[24] + 1) * sizeof(long long));
  auto ptr = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  const int ldx = static_cast<int>(a[13]);
  const bool f32 = a[14] != 0;
  const int M = static_cast<int>(a[15]), N = static_cast<int>(a[16]);
  const int K = static_cast<int>(a[17]), k_s = static_cast<int>(a[18]);
  const long long* plan = a + 19;
  const int nt = static_cast<int>(plan[0]);
  const int row_groups = static_cast<int>(plan[1]);
  const int col_tiles = static_cast<int>(plan[2]);
  Splits sp;
  sp.n4 = static_cast<int>(plan[3]);
  sp.nb = static_cast<int>(plan[4]);
  sp.count = static_cast<int>(plan[5]);
  if (sp.count < 1 || sp.count > kMaxSplits || row_groups < 1
      || col_tiles < 1 || M < 1 || N < 1 || k_s < 0 || k_s > K
      || (k_s & 1) || ((K - k_s) & 7) || ldx < 1
      || (ldx != K && !ptr(1))
      || (sp.n4 != (k_s + kKStep - 1) / kKStep)
      || (sp.nb != (K - k_s + kKStep - 1) / kKStep)
      || ((sp.count > 1 || (sp.n4 > 0 && sp.nb > 0)) && !ptr(10))
      || (sp.n4 + sp.nb > 0 && !ptr(11))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i <= sp.count; ++i) sp.b[i] = static_cast<int>(plan[6 + i]);
  for (int i = sp.count + 1; i <= kMaxSplits; ++i) sp.b[i] = sp.b[sp.count];
  Params p;
  p.w4 = static_cast<const uint8_t*>(ptr(2));
  p.s4 = static_cast<const float*>(ptr(3));
  p.z4 = static_cast<const float*>(ptr(4));
  p.bits = static_cast<const uint8_t*>(ptr(5));
  p.alpha_s = static_cast<const float*>(ptr(6));
  p.alpha_r1 = static_cast<const float*>(ptr(7));
  p.y = f32 ? nullptr : static_cast<__nv_bfloat16*>(ptr(9));
  p.yf = f32 ? static_cast<float*>(ptr(9)) : nullptr;
  p.ws = static_cast<float*>(ptr(10));
  p.xg = static_cast<const __nv_bfloat16*>(ptr(11));
  p.M = M;
  p.N = N;
  p.k_s = k_s;
  p.k_b = K - k_s;
  p.kp = kKStep * (sp.n4 + sp.nb);
  p.vec = (N % 16 == 0) && (a[2] % 16 == 0) && (a[5] % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(ptr(12));
  cudaError_t err;
  if (p.kp > 0) {
    const long long pairs = (long long)M * (p.kp / 2);
    gather_kernel<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, st>>>(
        static_cast<const unsigned short*>(ptr(0)),
        static_cast<const int*>(ptr(1)), static_cast<const float*>(ptr(8)),
        static_cast<uint32_t*>(ptr(11)), M, K, k_s, kKStep * sp.n4, p.kp,
        ldx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(col_tiles, sp.count, row_groups);
  switch (nt) {
    case 1: err = launch_nt<1>(p, sp, grid, st); break;
    case 2: err = launch_nt<2>(p, sp, grid, st); break;
    case 4: err = launch_nt<4>(p, sp, grid, st); break;
    case 8: err = launch_nt<8>(p, sp, grid, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || sp.count == 1) return static_cast<int>(err);
  const long long quads = (long long)M * ((N + 3) / 4);
  fold_kernel<<<static_cast<unsigned>((quads + 63) / 64), 64, 0, st>>>(
      p.ws, p.alpha_s, p.alpha_r1, p.y, p.yf, M, N, sp);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of packed_matmul_kernel with `nt` row tiles that one SM of the
// current device holds at once (its registers and shared memory as
// built), into *blocks: the `per_sm` of index.py::packed_matmul_plan.
extern "C" int packed_matmul_occupancy(int nt, int* blocks) {
  cudaError_t err;
  switch (nt) {
    case 1: err = occupancy<1>(blocks); break;
    case 2: err = occupancy<2>(blocks); break;
    case 4: err = occupancy<4>(blocks); break;
    case 8: err = occupancy<8>(blocks); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
