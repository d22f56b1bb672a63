// Device code shared by the binned-select kernels for Hopper (sm_90a): K1,
// K5 and K6 tiled (binned_coarse.cu, one CTA per query block and db tile)
// and the streaming / fused kernels of every arm (binned_stream.cu, one CTA
// per query block walking a run of db tiles).
//
// Every kernel of one arm computes each score with the same arithmetic, in
// the same order, so the tiled, streaming and fused outputs of the arm are
// bitwise equal:
//
//   bf16x3 (K1, K10, K11):
//     qh = bf16_rn(q), ql = bf16_rn(q - qh)                 (split_store)
//     acc += qh*th; acc += qh*tl; acc += ql*th, dim by dim   (fma_slice)
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
// The thread layout is fixed here too: a CTA of kThreads = 256 threads owns
// kBlockQ = 32 query rows and the 128 lanes of a column group; each thread
// owns a 4-query x 4-lane register tile (queries quad*4 + i, lanes
// lane_col + 32*j).  Shared-memory operands: bf16x3 stages f32 th/tl rows at
// a per-kernel row stride and query hi/lo parts k-major at kQStride; the int
// arms stage one 128-dim chunk as 32-bit words of 4 int8 dims, db rows at
// kIntDbStride words and query words k-major at kQStride.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace binned {

constexpr int kBinW = 128;       // lanes per group = bins per tile
constexpr int kSurvivors = 2;    // candidates per bin
constexpr int kBlockQ = 32;      // query rows per CTA
constexpr int kThreads = 256;    // 8 query quads x 32 lane columns
constexpr int kQuadQ = 4;        // query rows per thread
constexpr int kQuadL = 4;        // lanes per thread (strided 32 apart)
constexpr int kQStride = kBlockQ + 4;   // keeps float4 reads aligned

// The coarse pass's arithmetic arms; the values are the C entries' codes.
enum class Arm : int { kBf16x3 = 0, kInt8 = 1, kInt4 = 2 };

constexpr int kDimChunk = 128;            // dims per int chunk (DIM_CHUNK)
constexpr int kIntWords = kDimChunk / 4;  // int8 words of 4 dims per chunk
constexpr int kIntDbStride = kIntWords + 1;   // pad: conflict-free row reads

using Vals = float[kQuadQ][kQuadL][kSurvivors + 1];
using Gidx = int[kQuadQ][kQuadL][kSurvivors];
using Acc = float[kQuadQ][kQuadL];
using IAcc = int[kQuadQ][kQuadL];

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

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
    for (int j = 0; j < kQuadL; ++j) acc[i][j] = 0.0f;
}

// One query value split into hi/lo bf16 parts with round-to-nearest-even
// (JAX's astype), stored as f32 at k-major position ``at``.
__device__ __forceinline__ void split_store(float x, float* qhs, float* qls,
                                            int at) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(x);
  const float hf = __bfloat162float(hi);
  const __nv_bfloat16 lo = __float2bfloat16_rn(x - hf);
  qhs[at] = hf;
  qls[at] = __bfloat162float(lo);
}

// acc[i][j] += qh*th + qh*tl + ql*th over kSlice dims staged in shared memory
// (three FMAs per dim, in this order).  bf16 products are exact in f32, so
// these FMAs give the products a bf16 MMA with f32 accumulation gives.
template <int kSlice, int kDbStride>
__device__ __forceinline__ void fma_slice(const float* ths, const float* tls,
                                          const float* qhs, const float* qls,
                                          int quad, int lane_col, Acc& acc) {
#pragma unroll 4
  for (int k = 0; k < kSlice; ++k) {
    const float4 qh4 =
        *reinterpret_cast<const float4*>(qhs + k * kQStride + quad * 4);
    const float4 ql4 =
        *reinterpret_cast<const float4*>(qls + k * kQStride + quad * 4);
    const float qh[4] = {qh4.x, qh4.y, qh4.z, qh4.w};
    const float ql[4] = {ql4.x, ql4.y, ql4.z, ql4.w};
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
