// Device code shared by the binned-select kernels for Hopper (sm_90a): the
// tiled entries of every arm (binned_coarse.cu, one CTA per query block and
// db tile) and the streaming / fused entries of every arm (binned_stream.cu,
// one CTA per query block walking a run of db tiles).
//
// Every kernel of one arm computes each score with the same arithmetic, in
// the same order, so the tiled, streaming and fused outputs of the arm are
// bitwise equal.  Per 128-dim chunk c of the padded dims (nd = Dp / 128
// chunks), the f32-family arms sum the chunk's products into a chunk
// accumulator `cacc` zeroed at the chunk's start, and add the chunk into
// the score's running f32 sum `acc` at its end (acc = 0 + c_0 + c_1 + ...):
// the order of the TPU body, which adds each chunk's dot into its f32
// scratch (knn_tpu/ops/pallas_knn.py:493-503).  The f32 sums of chunk 0
// go straight into `acc`, and from chunk 1 on `acc` waits in shared memory
// (sum_chunks, in the kernels' multi-chunk build): one accumulator tile is
// in registers at a time.
//
//   bf16x3 (K1, K10, K11):
//     qh = bf16_rn(q), ql = bf16_rn(q - qh)                 (store_query)
//     cacc += qh*th; cacc += qh*tl; cacc += ql*th, dim by dim (fma_slice)
//   bf16x3f (K4): the same products, in the order of the TPU's one dot
//     over the 3x contraction [qh|qh|ql].[th|tl|th] (pallas_knn.py:407-414):
//     per chunk all 128 qh*th, then all qh*tl, then all ql*th, in one f32
//     chunk accumulator (three passes of fma_pair over the chunk, each
//     staging only the db part and query part it reads)
//   default (K3): the TPU's one bf16 pass, cacc += bf16_rn(q)*th (th is
//     bf16_rn(t)), f32 accumulation                          (fma_pair)
//   highest (K2): cacc += q*t in f64 (DFMA) over the f32 values, rounded
//     once to f32 at the chunk's end                         (fma_pair)
//   int8 (K5) / int4 (K6):
//     iacc += qi . ti in int32, 4 dims per __dp4a            (dp4a_chunk)
//       (int4 rows are unpacked to int8 words first:         (unpack_int4)
//        (b & 0xF) - 8 and (b >> 4) - 8)
//     acc = (f32_rn(iacc) * qsc) * ts, each product rounded  (rescale)
//   then s = tnorm[t] - 2*acc and the strict-`<` insertion   (insert_group)
//   network that keeps 2 survivors + the bin bound
//
// The int dot is exact (|qi.ti| <= 127^2 * dp fits int32 far past any real
// dim), so the one f32 rounding is the rescale's, in the TPU kernel's order
// (knn_tpu/ops/pallas_knn.py:475-476).
//
// Worst-case rounding of the f32-family scores, u = 2^-24, P = sum_i |q_i
// t_i| <= ||q|| ||t|| <= (||q||^2 + M) / 2 with M = max ||t||^2:
//
//   bf16x3, bf16x3f.  Products of bf16 values are exact in f32, so the only
//     accumulation error is the summation's: a chain of 3*128 terms per
//     chunk, then nd - 1 chunk additions, |err(qt)| <= (384 + nd) u P (1 +
//     2^-7).  In s = tn - 2 qt that is <= (384 + nd) u (||q||^2 + M) =
//     (0.375 + nd / 1024) 2^-14 (||q||^2 + M), under the certificate's
//     2^-14 tolerance for any dim.  (A single chain of 3 Dp terms, as K1
//     ran before, gives 3 Dp u (||q||^2 + M): past Dp ~ 340 that alone
//     exceeds the tolerance, ~2.6x at Dp = 896.)  The split itself is not
//     exact: q t - (qh th + qh tl + ql th) <= 3 * 2^-16 |q t| per dim (the
//     dropped ql tl and the two low-part roundings), i.e. up to 0.75 of the
//     tolerance in s when every dim's roundings are at their largest and
//     align; the reference's tolerance model (pallas_knn.py:1532-1534) puts
//     them at 1/16.  Together the two can pass 2^-14 by up to ~13% only on
//     such constructed input; ROADMAP queue C, fault 12.
//   highest.  Each product of two f32 values is exact in f64; the chunk's
//     f64 sum errs by <= 127 * 2^-53 P_c and its rounding to f32 by u P_c;
//     the nd - 1 f32 chunk additions by (nd - 1) u P.  So |err(qt)| <=
//     nd u P (1 + 2^-20), and in s, with the rounding of tn - 2 qt,
//     <= (nd + 2) u (||q||^2 + M): 3 u at Dp = 128, 9 u at Dp = 896, against
//     the certificate's budget of 32 eps_f32 (||q||^2 + M) = 64 u (||q||^2 +
//     M) (pallas_knn.py:1573, sharded.py:2366).  The rest of the budget
//     covers the f32 row and query norm reductions (each <= (1 + log2 Dp) u
//     ||x||^2 as tree sums) and the certificate's own f32 arithmetic.  A
//     plain f32 chain over one chunk (128 u P per chunk) would not fit:
//     2 * 128 u P <= 2^-17 (||q||^2 + M), twice the budget.
//   default.  No tolerance model (the reference refuses it in the one-pass
//     certificate): bf16_rn(q) bf16_rn(t) - q t <= (2^-7 + 2^-16) |q t| per
//     dim, plus (128 + nd) u P of f32 accumulation.  It serves the counted
//     certificate, which does not depend on the coarse pass's precision.
//
// The thread layout is fixed here too: a CTA of kThreads = 256 threads owns
// kBlockQ = 32 query rows and the 128 lanes of a column group; each thread
// owns a 4-query x 4-lane register tile (queries quad*4 + i, lanes
// lane_col + 32*j).  Shared-memory operands of the f32 family: db rows at a
// per-kernel row stride (f32 th / tl, or f64 t for highest) and query parts
// k-major at kQStride (f32 hi / lo, or f64 q for highest); the int arms
// stage one 128-dim chunk as 32-bit words of 4 int8 dims, db rows at
// kIntDbStride words and query words k-major at kQStride.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace binned {

constexpr int kBinW = 128;       // lanes per group = bins per tile
constexpr int kSurvivors = 2;    // candidates per bin
constexpr int kBlockQ = 32;      // query rows per CTA
constexpr int kThreads = 256;    // 8 query quads x 32 lane columns
constexpr int kQuadQ = 4;        // query rows per thread
constexpr int kQuadL = 4;        // lanes per thread (strided 32 apart)
constexpr int kQStride = kBlockQ + 4;   // keeps float4 / double2 reads aligned

// The coarse pass's arithmetic arms; the values are the C entries' codes
// (ops/coarse_knn.ARMS order).
enum class Arm : int {
  kBf16x3 = 0,
  kInt8 = 1,
  kInt4 = 2,
  kBf16x3f = 3,
  kHighest = 4,
  kDefault = 5
};

constexpr int kDimChunk = 128;            // dims per chunk (DIM_CHUNK)
constexpr int kIntWords = kDimChunk / 4;  // int8 words of 4 dims per chunk
constexpr int kIntDbStride = kIntWords + 1;   // pad: conflict-free row reads

template <Arm kArm>
constexpr bool kIsInt = kArm == Arm::kInt8 || kArm == Arm::kInt4;

// Passes over each chunk: bf16x3f walks it three times (qh.th, qh.tl,
// ql.th), every other arm once.
template <Arm kArm>
constexpr int kPasses = kArm == Arm::kBf16x3f ? 3 : 1;

// The f32 family's shared-memory element and chunk-accumulator type: f64
// for highest, f32 for the bf16 arms.
template <Arm kArm>
using Elem = std::conditional_t<kArm == Arm::kHighest, double, float>;

// bf16x3 stages both bf16 parts of the db and of the query (th, tl, qh,
// ql) for each slice; bf16x3f one of each per pass (th + qh, tl + qh,
// th + ql); default the hi parts alone.
template <Arm kArm>
constexpr bool kUsesLo = kArm == Arm::kBf16x3;

// The db part (0: th or t, 1: tl) and query part (0: qh or q, 1: ql) that
// pass ``pass`` of a chunk reads.
template <Arm kArm>
__host__ __device__ constexpr int db_part(int pass) {
  return kArm == Arm::kBf16x3f && pass == 1 ? 1 : 0;
}

template <Arm kArm>
__host__ __device__ constexpr int q_part(int pass) {
  return kArm == Arm::kBf16x3f && pass == 2 ? 1 : 0;
}

// CTAs per SM the kernels are compiled for: highest's f64 chunk
// accumulators need more than the 128 registers two CTAs leave a thread.
template <Arm kArm>
constexpr int kMinCtas = kArm == Arm::kHighest ? 1 : 2;

// Bytes of the f32 family's compute buffers for a slice of kSlice dims:
// two f32 db parts [128][kSlice+1] and two f32 query parts [kSlice][kQStride]
// (bf16 arms), or one f64 db part and one f64 query part (highest) -- the
// same size.
template <int kSlice>
constexpr size_t kF32ComputeBytes =
    sizeof(double) * (kBinW * (kSlice + 1) + kSlice * kQStride);

using Vals = float[kQuadQ][kQuadL][kSurvivors + 1];
using Gidx = int[kQuadQ][kQuadL][kSurvivors];
using Acc = float[kQuadQ][kQuadL];
using IAcc = int[kQuadQ][kQuadL];
template <typename T>
using Tile = T[kQuadQ][kQuadL];

// Db bytes per row of an arm's operand for dp dims: int8 one per dim, int4
// two dims per byte.
template <Arm kArm>
__host__ __device__ constexpr int db_row_bytes(int dp) {
  return kArm == Arm::kInt4 ? dp / 2 : dp;
}

__device__ __forceinline__ void reset_bins(Vals& vals, Gidx& gidx) {
#pragma unroll
  for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
    for (int j = 0; j < kQuadL; ++j) {
#pragma unroll
      for (int s = 0; s <= kSurvivors; ++s)
        vals[i][j][s] = __int_as_float(0x7f800000);
#pragma unroll
      for (int s = 0; s < kSurvivors; ++s) gidx[i][j][s] = 0;
    }
}

template <typename T>
__device__ __forceinline__ void zero_tile(Tile<T>& acc) {
#pragma unroll
  for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
    for (int j = 0; j < kQuadL; ++j) acc[i][j] = T(0);
}

// A chunk's sum as f32: highest's f64 sum rounded once.
template <typename T>
__device__ __forceinline__ float chunk_f32(T c) {
  if constexpr (std::is_same_v<T, double>)
    return __double2float_rn(c);
  else
    return c;
}

// Bytes of the running sums that chunks 1 .. nd-1 are added into: one f32
// tile per thread in shared memory, element (i, j) of thread tid at
// [(i * kQuadL + j) * kThreads + tid] (conflict-free).
constexpr size_t kRunBytes = sizeof(float) * kQuadQ * kQuadL * kThreads;

// The f32 family's score sums acc = 0 + c_0 + c_1 + ... over nd chunks,
// where chunk(c, sum) adds the products of chunk c into ``sum`` (f32, or
// f64 for highest).  The bf16 arms sum chunk 0 straight into acc (0 + c_0
// == c_0, and an FMA chain from +0 never ends at -0).  Every f32 kernel is
// built twice and launched by Dp: kMulti = false for Dp = 128 (nd = 1: the
// one chunk, nothing else -- the register and shared-memory footprint of
// a single chain), kMulti = true for Dp > 128, where chunks 1 .. nd-1 go
// through a chunk tile while the running sum waits in shared memory
// (``run``, kRunBytes), so one accumulator tile is in registers at a time.
// Both give the same bits.
template <Arm kArm, bool kMulti, typename ChunkFn>
__device__ __forceinline__ void sum_chunks(int nd, float* run, int tid,
                                           ChunkFn&& chunk, Acc& acc) {
  zero_tile(acc);
  if constexpr (kArm == Arm::kHighest) {
    Tile<double> c0;
    zero_tile(c0);
    chunk(0, c0);
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
      for (int j = 0; j < kQuadL; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], chunk_f32(c0[i][j]));
  } else {
    chunk(0, acc);
  }
  if constexpr (kMulti) {
#pragma unroll
    for (int e = 0; e < kQuadQ * kQuadL; ++e)
      run[e * kThreads + tid] = acc[e / kQuadL][e % kQuadL];
    for (int c = 1; c < nd; ++c) {
      Tile<Elem<kArm>> cacc;
      zero_tile(cacc);
      chunk(c, cacc);
#pragma unroll
      for (int e = 0; e < kQuadQ * kQuadL; ++e) {
        float& r = run[e * kThreads + tid];
        r = __fadd_rn(r, chunk_f32(cacc[e / kQuadL][e % kQuadL]));
      }
    }
#pragma unroll
    for (int e = 0; e < kQuadQ * kQuadL; ++e)
      acc[e / kQuadL][e % kQuadL] = run[e * kThreads + tid];
  }
}

// One query value as the arm stores it at k-major position ``at``: the
// hi / lo bf16 parts with round-to-nearest-even (JAX's astype) as f32
// (bf16x3 both, in qa and qb; bf16x3f the part pass ``pass`` reads, in qa;
// default the hi part), or the value as f64 (highest, converted once here,
// not per product).
template <Arm kArm>
__device__ __forceinline__ void store_query(float x, void* qa, void* qb,
                                            int at, int pass) {
  if constexpr (kArm == Arm::kHighest) {
    static_cast<double*>(qa)[at] = static_cast<double>(x);
  } else {
    const float hf = __bfloat162float(__float2bfloat16_rn(x));
    if constexpr (kUsesLo<kArm>) {
      static_cast<float*>(qa)[at] = hf;
      static_cast<float*>(qb)[at] = __bfloat162float(__float2bfloat16_rn(x - hf));
    } else {
      static_cast<float*>(qa)[at] =
          q_part<kArm>(pass) ? __bfloat162float(__float2bfloat16_rn(x - hf))
                             : hf;
    }
  }
}

// This thread's 4 query values at k-major row k (16-byte loads).
__device__ __forceinline__ void load_q4(const float* qs, int k, int quad,
                                        float (&out)[kQuadQ]) {
  const float4 v = *reinterpret_cast<const float4*>(qs + k * kQStride + quad * 4);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load_q4(const double* qs, int k, int quad,
                                        double (&out)[kQuadQ]) {
  const double2* p =
      reinterpret_cast<const double2*>(qs + k * kQStride + quad * 4);
  const double2 a = p[0], b = p[1];
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// K1's order: cacc[i][j] += qh*th + qh*tl + ql*th over kSlice dims staged in
// shared memory (three FMAs per dim, in this order).  bf16 products are
// exact in f32, so these FMAs give the products a bf16 MMA with f32
// accumulation gives.
template <int kSlice, int kDbStride>
__device__ __forceinline__ void fma_slice(const float* ths, const float* tls,
                                          const float* qhs, const float* qls,
                                          int quad, int lane_col, Acc& acc) {
#pragma unroll 4
  for (int k = 0; k < kSlice; ++k) {
    float qh[kQuadQ], ql[kQuadQ];
    load_q4(qhs, k, quad, qh);
    load_q4(qls, k, quad, ql);
    float tv[kQuadL], lv[kQuadL];
#pragma unroll
    for (int j = 0; j < kQuadL; ++j) {
      tv[j] = ths[(lane_col + 32 * j) * kDbStride + k];
      lv[j] = tls[(lane_col + 32 * j) * kDbStride + k];
    }
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
      for (int j = 0; j < kQuadL; ++j) {
        acc[i][j] = fmaf(qh[i], tv[j], acc[i][j]);
        acc[i][j] = fmaf(qh[i], lv[j], acc[i][j]);
        acc[i][j] = fmaf(ql[i], tv[j], acc[i][j]);
      }
  }
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// One product per dim: cacc[i][j] += q*t over kSlice dims of one db part
// and one query part (f32 FMA, or f64 DFMA for highest).
template <int kSlice, int kDbStride, typename T>
__device__ __forceinline__ void fma_pair(const T* ts, const T* qs, int quad,
                                         int lane_col, Tile<T>& acc) {
  // ts: [128][kDbStride] db values, qs: [kSlice][kQStride] query values
#pragma unroll 4
  for (int k = 0; k < kSlice; ++k) {
    T qv[kQuadQ];
    load_q4(qs, k, quad, qv);
    T tv[kQuadL];
#pragma unroll
    for (int j = 0; j < kQuadL; ++j)
      tv[j] = ts[(lane_col + 32 * j) * kDbStride + k];
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
      for (int j = 0; j < kQuadL; ++j)
        acc[i][j] = fma_rn(qv[i], tv[j], acc[i][j]);
  }
}

// Where a slice's db rows and query values go in the compute buffers:
// th, tl, qh, ql (bf16x3); the pass's db part and query part (bf16x3f);
// th, qh (default); t, q as f64 (highest).
template <Arm kArm, int kSlice, int kDbStride>
struct F32Bufs {
  void* db0;   // [128][kDbStride]
  void* db1;   // tl, [128][kDbStride] (bf16x3)
  void* qa;    // [kSlice][kQStride]
  void* qb;    // ql, [kSlice][kQStride] (bf16x3)
  __device__ explicit F32Bufs(void* cbuf) {
    using T = Elem<kArm>;
    T* p = static_cast<T*>(cbuf);
    db0 = p;
    if constexpr (kUsesLo<kArm>) {
      db1 = p + kBinW * kDbStride;
      qa = p + 2 * kBinW * kDbStride;
      qb = p + 2 * kBinW * kDbStride + kSlice * kQStride;
    } else {
      db1 = nullptr;
      qa = p + kBinW * kDbStride;
      qb = nullptr;
    }
  }
};

// The f32 family's products over one staged slice into ``acc``: K1's three
// per dim, or one per dim of the staged pair (the other arms; bf16x3f's
// pass staged the pair it reads).
template <Arm kArm, int kSlice, int kDbStride>
__device__ __forceinline__ void slice_products(
    const F32Bufs<kArm, kSlice, kDbStride>& b, int quad, int lane_col,
    Tile<Elem<kArm>>& acc) {
  using T = Elem<kArm>;
  if constexpr (kUsesLo<kArm>)
    fma_slice<kSlice, kDbStride>(
        static_cast<const float*>(b.db0), static_cast<const float*>(b.db1),
        static_cast<const float*>(b.qa), static_cast<const float*>(b.qb),
        quad, lane_col, acc);
  else
    fma_pair<kSlice, kDbStride>(static_cast<const T*>(b.db0),
                                static_cast<const T*>(b.qa), quad, lane_col,
                                acc);
}

// Stores 8 consecutive db values of row r, dims c .. c+7 of the slice, into
// the compute buffers: bf16 (8 of th or tl, 16 bytes) upcast to f32, or f32
// (two 16-byte halves, 4 each) converted to f64.
__device__ __forceinline__ void put_bf16x8(uint4 v, float* dst) {
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(b[e]);
}

__device__ __forceinline__ void put_f32x4(float4 v, double* dst) {
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void zero_iacc(IAcc& acc) {
#pragma unroll
  for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
    for (int j = 0; j < kQuadL; ++j) acc[i][j] = 0;
}

// One 32-bit word of 4 packed int4 bytes (chunk bytes j .. j+3) as the int8
// words of dims j .. j+3 (low nibbles) and 64+j .. 64+j+3 (high nibbles) of
// the chunk: the chunk-paired layout of knn_tpu_torch/ops/quantize.py
// pack_nibbles, biased +8.
__device__ __forceinline__ void unpack_int4(unsigned x, int& lo, int& hi) {
  lo = static_cast<int>(__vsub4(x & 0x0F0F0F0Fu, 0x08080808u));
  hi = static_cast<int>(__vsub4((x >> 4) & 0x0F0F0F0Fu, 0x08080808u));
}

// Stages one 128-dim chunk of 128 db rows as int8 words: word w (dims
// 4w .. 4w+3 of the chunk) of row r at dst[r * kIntDbStride + w].  The
// chunk's bytes of row r are at src + r * src_stride (global or shared
// memory, 16-byte aligned); int4 bytes are unpacked on the way.
template <Arm kArm>
__device__ __forceinline__ void stage_db_words(const uint8_t* src,
                                               size_t src_stride, int* dst,
                                               int tid) {
  constexpr int kSegs = db_row_bytes<kArm>(kDimChunk) / 16;  // loads per row
#pragma unroll
  for (int p = 0; p < kBinW * kSegs / kThreads; ++p) {
    const int idx = tid + p * kThreads;
    const int r = idx / kSegs;
    const int seg = idx % kSegs;
    const uint4 v = *reinterpret_cast<const uint4*>(src + r * src_stride +
                                                    seg * 16);
    const unsigned xs[4] = {v.x, v.y, v.z, v.w};
    int* row = dst + r * kIntDbStride;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kArm == Arm::kInt4) {
        int lo, hi;
        unpack_int4(xs[e], lo, hi);
        row[seg * 4 + e] = lo;
        row[kIntWords / 2 + seg * 4 + e] = hi;
      } else {
        row[seg * 4 + e] = static_cast<int>(xs[e]);
      }
    }
  }
}

// Stages one 128-dim chunk of the query block's int8 rows k-major: word w
// of row r at dst[w * kQStride + r].  Row r's chunk is at src + r *
// src_stride; rows at or past `live` are written as zeros.
__device__ __forceinline__ void stage_q_words(const int8_t* src,
                                              size_t src_stride, int live,
                                              int* dst, int tid) {
  const int r = tid / (kDimChunk / 16);
  const int seg = tid % (kDimChunk / 16);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (r < live)
    v = *reinterpret_cast<const uint4*>(src + r * src_stride + seg * 16);
  const unsigned xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    dst[(seg * 4 + e) * kQStride + r] = static_cast<int>(xs[e]);
}

// acc[i][j] += qi . ti over one staged 128-dim chunk, 4 dims per __dp4a
// (exact int32).
__device__ __forceinline__ void dp4a_chunk(const int* tws, const int* qws,
                                           int quad, int lane_col,
                                           IAcc& acc) {
#pragma unroll 4
  for (int w = 0; w < kIntWords; ++w) {
    const int4 q4 =
        *reinterpret_cast<const int4*>(qws + w * kQStride + quad * 4);
    const int qv[4] = {q4.x, q4.y, q4.z, q4.w};
    int tv[kQuadL];
#pragma unroll
    for (int j = 0; j < kQuadL; ++j)
      tv[j] = tws[(lane_col + 32 * j) * kIntDbStride + w];
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
      for (int j = 0; j < kQuadL; ++j)
        acc[i][j] = __dp4a(qv[i], tv[j], acc[i][j]);
  }
}

// The query scales of this thread's rows quad*4 + i of the block at q0
// (0 past n_q: those rows are never written).
__device__ __forceinline__ void load_qsc(const float* __restrict__ qsc,
                                         int q0, int quad, int n_q,
                                         float (&out)[kQuadQ]) {
#pragma unroll
  for (int i = 0; i < kQuadQ; ++i) {
    const int row = q0 + quad * 4 + i;
    out[i] = row < n_q ? qsc[row] : 0.0f;
  }
}

// The one f32 rounding of the int arms, in the TPU kernel's order:
// acc = (f32_rn(dot) * qsc) * ts, each product rounded to nearest (the _rn
// intrinsics keep nvcc from contracting or reordering them).
__device__ __forceinline__ void rescale(const IAcc& iacc,
                                        const float (&qsc)[kQuadQ],
                                        const float* __restrict__ tscale,
                                        size_t row0, int lane_col,
                                        Acc& acc) {
#pragma unroll
  for (int j = 0; j < kQuadL; ++j) {
    const float ts = tscale[row0 + lane_col + 32 * j];
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i)
      acc[i][j] =
          __fmul_rn(__fmul_rn(__int2float_rn(iacc[i][j]), qsc[i]), ts);
  }
}

// s = tn - 2 qt for group g (db rows row0 .. row0+127), then the sorted
// insertion network with strict `<`: the earlier group wins a tie.
__device__ __forceinline__ void insert_group(Vals& vals, Gidx& gidx,
                                             const Acc& acc,
                                             const float* __restrict__ tnorm,
                                             size_t row0, int lane_col, int g) {
#pragma unroll
  for (int j = 0; j < kQuadL; ++j) {
    const float tn = tnorm[row0 + lane_col + 32 * j];
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i) {
      float cur_v = tn - 2.0f * acc[i][j];
      int cur_g = g;
#pragma unroll
      for (int s = 0; s < kSurvivors; ++s) {
        const bool less = cur_v < vals[i][j][s];
        const float disp_v = fmaxf(cur_v, vals[i][j][s]);
        const int disp_g = less ? gidx[i][j][s] : cur_g;
        vals[i][j][s] = fminf(cur_v, vals[i][j][s]);
        gidx[i][j][s] = less ? cur_g : gidx[i][j][s];
        cur_v = disp_v;
        cur_g = disp_g;
      }
      vals[i][j][kSurvivors] = fminf(vals[i][j][kSurvivors], cur_v);
    }
  }
}

// Writes tile ti's block for this thread's rows and lanes: survivors to
// cd/ci at column ti*256 + s*128 + lane (index INT32_MAX where the value is
// not finite), the bound to bounds at ti*128 + lane.  ``pad`` writes the
// block of a skipped tile instead: +inf, INT32_MAX, +inf.
__device__ __forceinline__ void store_tile(const Vals& vals, const Gidx& gidx,
                                           float* __restrict__ cd,
                                           int* __restrict__ ci,
                                           float* __restrict__ bounds, int q0,
                                           int quad, int lane_col, int n_q,
                                           int n_tiles, int ti, int tile_n,
                                           bool pad) {
  const float inf = __int_as_float(0x7f800000);
  const size_t out_w = static_cast<size_t>(n_tiles) * kSurvivors * kBinW;
  const size_t bound_w = static_cast<size_t>(n_tiles) * kBinW;
#pragma unroll
  for (int i = 0; i < kQuadQ; ++i) {
    const int row = q0 + quad * 4 + i;
    if (row >= n_q) continue;
#pragma unroll
    for (int j = 0; j < kQuadL; ++j) {
      const int lane = lane_col + 32 * j;
#pragma unroll
      for (int s = 0; s < kSurvivors; ++s) {
        const size_t col =
            static_cast<size_t>(ti) * kSurvivors * kBinW + s * kBinW + lane;
        const float v = vals[i][j][s];
        cd[row * out_w + col] = pad ? inf : v;
        ci[row * out_w + col] =
            (pad || !isfinite(v)) ? INT32_MAX
                                  : ti * tile_n + gidx[i][j][s] * kBinW + lane;
      }
      bounds[row * bound_w + static_cast<size_t>(ti) * kBinW + lane] =
          pad ? inf : vals[i][j][kSurvivors];
    }
  }
}

}  // namespace binned
