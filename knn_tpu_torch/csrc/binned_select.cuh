// Device code shared by the binned-select kernels for Hopper (sm_90a): the
// tiled entries of every arm (binned_coarse.cu, one CTA per query block and
// db tile) and the streaming / fused entries of every arm (binned_stream.cu,
// one CTA per query block walking a run of db tiles): the per-score
// arithmetic of the CUDA-core arms (this part), both emitters (grouped and
// lane binning, K8), and K11's carry and skip, below.  The bf16x3 (K1, K10,
// K11) and bf16x3f (K4) arms run on the bf16 tensor cores and highest (K2)
// on the FP64 tensor cores (binned_mma.cuh); the pq arm's walk (K7) is
// binned_pq.cuh.
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
//   bf16x3 (K1, K10, K11): qh.th + (qh.tl + ql.th) per chunk on tensor
//     cores, chunks added in f32 (binned_mma.cuh)
//   bf16x3f (K4): qh.th, qh.tl, ql.th of every k-step into one tensor-core
//     accumulator per chunk (the TPU's one dot over the 3x contraction
//     [qh|qh|ql].[th|tl|th], pallas_knn.py:407-414), chunks added in f32
//     (binned_mma.cuh)
//   highest (K2): q*t of the f32 values summed in f64 on the FP64 tensor
//     cores (mma m16n8k8), rounded once to f32 at the chunk's end, chunks
//     added in f32 (binned_mma.cuh)
//   default (K3): the TPU's one bf16 pass, cacc += bf16_rn(q)*th (th is
//     bf16_rn(t)), f32 accumulation                          (fma_pair)
//   int8 (K5) / int4 (K6):
//     iacc += qi . ti in int32, 4 dims per __dp4a            (dp4a_chunk)
//       (int4 rows are unpacked to int8 words first:         (unpack_int4)
//        (b & 0xF) - 8 and (b >> 4) - 8)
//     acc = (f32_rn(iacc) * qsc) * ts, each product rounded  (rescale)
//   then s = tnorm[t] - 2*acc and the emitter: the strict-`<` insertion
//   network that keeps 2 survivors + the bin bound (grouped), or the lane
//   merge (K8)
//
// The int dot is exact (|qi.ti| <= 127^2 * dp fits int32 far past any real
// dim), so the one f32 rounding is the rescale's, in the TPU kernel's order
// (knn_tpu/ops/pallas_knn.py:475-476).
//
// Worst-case rounding of the f32-family scores, u = 2^-24, P = sum_i |q_i
// t_i| <= ||q|| ||t|| <= (||q||^2 + M) / 2 with M = max ||t||^2:
//
//   bf16x3, bf16x3f: the certificate's slack, proved (coarse_knn.
//     bf16_tolerance_scale, read by the host tolerance and the device
//     certificate alike).  Three terms, per unit of (||q||^2 + M) in s:
//     - the split.  bf16 keeps 8 significant bits: |q - qh| <= 2^-8 |q|,
//       ql = bf16_rn(q - qh) errs by <= 2^-16 |q|, so q = qh + ql + e_q
//       with |e_q| <= 2^-16 |q| (t likewise), and q t - (qh th + qh tl +
//       ql th) = ql tl + e_q t' + q' e_t, at most 3 * 2^-16 (1 + 2^-7) |q
//       t| per dim.  Doubled in s over sum |q_i t_i| <= P: SPLIT_SCALE =
//       3 * 2^-16 (1 + 2^-7) = 0.756 of 2^-14, reached when every dim's
//       roundings are at their largest and align (the reference's model,
//       pallas_knn.py:1532-1534, puts them at 1/16 of 2^-14);
//     - the summation.  Products of bf16 values are exact in f32; on
//       tensor cores (binned_mma.cuh, coarse_knn.accumulation_coefficient)
//       bf16x3 (320 + nd)(1 + 2^-7) u, bf16x3f (960 + nd - 1)(1 + 2^-7) u;
//     - the headroom: 64 u for the f32 norms, the rounding of s and the
//       certificate's f32 adds, the budget the highest arm keeps below.
//     Their sum, 0.756 + 0.316 + 0.063 = 1.134 of 2^-14 (bf16x3, Dp = 128)
//     or 0.756 + 0.945 + 0.063 = 1.763 (bf16x3f), replaces the reference's
//     2^-14 whenever it is larger (ROADMAP divergence 18; the sum of the
//     split and a CUDA-core chain could pass 2^-14 by ~13%, fault 18).
//   highest.  Each product of two f32 values is exact in f64.  A chunk's
//     products are summed on the FP64 tensor cores in 16 k-steps of 8
//     (binned_mma.cuh states the step model the probe checks: every f64
//     add rounds to nearest, in any order within a step, so a step of k
//     products errs by <= k 2^-53 (|c| + sum |p|)); the 16 steps err by <=
//     128 * 2^-53 P_c, the rounding to f32 by u P_c (1 + 2^-22), the nd - 1
//     f32 chunk additions by (nd - 1) u P.  So |err(qt)| <= nd u P (1 +
//     2^-20), and in s, with the rounding of tn - 2 qt, <= (nd + 2) u
//     (||q||^2 + M): 3 u at Dp = 128, 9 u at Dp = 896, against the
//     certificate's budget of 32 eps_f32 (||q||^2 + M) = 64 u (||q||^2 +
//     M) (pallas_knn.py:1573, sharded.py:2366).  The rest of the budget
//     covers the f32 row and query norm reductions (each <= (1 + log2 Dp) u
//     ||x||^2 as tree sums) and the certificate's own f32 arithmetic.  A
//     plain f32 chain over one chunk (128 u P per chunk) would not fit:
//     2 * 128 u P <= 2^-17 (||q||^2 + M), twice the budget; nor would
//     3xTF32 on the tf32 tensor cores (binned_mma.cuh's step model with
//     f32 accumulation: 16 steps of 20 u for the hi.hi product alone, 320
//     u P per chunk, five times the whole budget in s).
//   default.  No tolerance model (the reference refuses it in the one-pass
//     certificate): bf16_rn(q) bf16_rn(t) - q t <= (2^-7 + 2^-16) |q t| per
//     dim, plus (128 + nd) u P of f32 accumulation.  It serves the counted
//     certificate, which does not depend on the coarse pass's precision.
//
// The thread layout is fixed here too: a CTA of kThreads = 256 threads owns
// kBlockQ = 32 query rows and the 128 lanes of a column group; each thread
// owns a 4-query x 4-lane register tile (queries quad*4 + i, lanes
// lane_col + 32*j).  Shared-memory operands of the CUDA-core default arm:
// db rows (f32 th) at a per-kernel row stride and the query's bf16 part
// k-major at kQStride; the int arms stage one 128-dim chunk as 32-bit
// words of 4 int8 dims, db rows at kIntDbStride words and query words
// k-major at kQStride.

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
constexpr int kMaxCarry = 8;             // MAX_CARRY_DEPTH (K11's carry)

// The coarse pass's arithmetic arms; the values are the C entries' codes
// (ops/coarse_knn.ARMS order).
enum class Arm : int {
  kBf16x3 = 0,
  kInt8 = 1,
  kInt4 = 2,
  kBf16x3f = 3,
  kHighest = 4,
  kDefault = 5,
  kPq = 6
};

constexpr int kDimChunk = 128;            // dims per chunk (DIM_CHUNK)
constexpr int kIntWords = kDimChunk / 4;  // int8 words of 4 dims per chunk
constexpr int kIntDbStride = kIntWords + 1;   // pad: conflict-free row reads

template <Arm kArm>
constexpr bool kIsInt = kArm == Arm::kInt8 || kArm == Arm::kInt4;

// CTAs per SM the CUDA-core kernels (default and the int arms) are
// compiled for.
constexpr int kCudaCoreCtas = 2;

// Bytes of the CUDA-core default arm's compute buffers for a slice of
// kSlice dims: the db part [128][kSlice+1] f32 and the query part
// [kSlice][kQStride] f32.
template <int kSlice>
constexpr size_t kF32ComputeBytes =
    sizeof(float) * (kBinW * (kSlice + 1) + kSlice * kQStride);

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

__device__ __forceinline__ void zero_tile(Acc& acc) {
#pragma unroll
  for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
    for (int j = 0; j < kQuadL; ++j) acc[i][j] = 0.0f;
}

// Bytes of the running sums that chunks 1 .. nd-1 are added into: one f32
// tile per thread in shared memory, element (i, j) of thread tid at
// [(i * kQuadL + j) * kThreads + tid] (conflict-free).
constexpr size_t kRunBytes = sizeof(float) * kQuadQ * kQuadL * kThreads;

// The CUDA-core default arm's score sums acc = 0 + c_0 + c_1 + ... over nd
// chunks, where chunk(c, sum) adds the products of chunk c into ``sum``.
// Chunk 0 goes straight into acc (0 + c_0 == c_0, and an FMA chain from +0
// never ends at -0).  The kernel is built twice and launched by Dp: kMulti
// = false for Dp = 128 (nd = 1: the one chunk, nothing else -- the register
// and shared-memory footprint of a single chain), kMulti = true for Dp >
// 128, where chunks 1 .. nd-1 go through a chunk tile while the running sum
// waits in shared memory (``run``, kRunBytes), so one accumulator tile is in
// registers at a time.  Both give the same bits.
template <bool kMulti, typename ChunkFn>
__device__ __forceinline__ void sum_chunks(int nd, float* run, int tid,
                                           ChunkFn&& chunk, Acc& acc) {
  zero_tile(acc);
  chunk(0, acc);
  if constexpr (kMulti) {
#pragma unroll
    for (int e = 0; e < kQuadQ * kQuadL; ++e)
      run[e * kThreads + tid] = acc[e / kQuadL][e % kQuadL];
    for (int c = 1; c < nd; ++c) {
      Acc cacc;
      zero_tile(cacc);
      chunk(c, cacc);
#pragma unroll
      for (int e = 0; e < kQuadQ * kQuadL; ++e) {
        float& r = run[e * kThreads + tid];
        r = __fadd_rn(r, cacc[e / kQuadL][e % kQuadL]);
      }
    }
#pragma unroll
    for (int e = 0; e < kQuadQ * kQuadL; ++e)
      acc[e / kQuadL][e % kQuadL] = run[e * kThreads + tid];
  }
}

// One query value as the default arm stores it at k-major position ``at``:
// its bf16 part with round-to-nearest-even (JAX's astype), as f32.
__device__ __forceinline__ void store_query(float x, float* qa, int at) {
  qa[at] = __bfloat162float(__float2bfloat16_rn(x));
}

// This thread's 4 query values at k-major row k (16-byte loads).
__device__ __forceinline__ void load_q4(const float* qs, int k, int quad,
                                        float (&out)[kQuadQ]) {
  const float4 v = *reinterpret_cast<const float4*>(qs + k * kQStride + quad * 4);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// One product per dim: acc[i][j] += q*t (f32 FMA) over kSlice dims of one
// db part and one query part.
template <int kSlice, int kDbStride>
__device__ __forceinline__ void fma_pair(const float* ts, const float* qs,
                                         int quad, int lane_col, Acc& acc) {
  // ts: [128][kDbStride] db values, qs: [kSlice][kQStride] query values
#pragma unroll 4
  for (int k = 0; k < kSlice; ++k) {
    float qv[kQuadQ];
    load_q4(qs, k, quad, qv);
    float tv[kQuadL];
#pragma unroll
    for (int j = 0; j < kQuadL; ++j)
      tv[j] = ts[(lane_col + 32 * j) * kDbStride + k];
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
      for (int j = 0; j < kQuadL; ++j)
        acc[i][j] = __fmaf_rn(qv[i], tv[j], acc[i][j]);
  }
}

// Where a slice's db rows (th as f32) and query values (bf16 parts as f32)
// go in the default arm's compute buffers.
template <int kSlice, int kDbStride>
struct F32Bufs {
  float* db0;   // [128][kDbStride]
  float* qa;    // [kSlice][kQStride]
  __device__ explicit F32Bufs(void* cbuf)
      : db0(static_cast<float*>(cbuf)), qa(db0 + kBinW * kDbStride) {}
};

// The default arm's products over one staged slice into ``acc``: one per
// dim of the staged pair.
template <int kSlice, int kDbStride>
__device__ __forceinline__ void slice_products(
    const F32Bufs<kSlice, kDbStride>& b, int quad, int lane_col, Acc& acc) {
  fma_pair<kSlice, kDbStride>(b.db0, b.qa, quad, lane_col, acc);
}

// Stores 8 consecutive db values of row r, dims c .. c+7 of the slice, into
// the compute buffers: bf16 (8 of th, 16 bytes) upcast to f32.
__device__ __forceinline__ void put_bf16x8(uint4 v, float* dst) {
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(b[e]);
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


// ---------------------------------------------------------------------------
// The two emitters (pallas_knn.py:506-610).  A launch takes its binning as a
// runtime geometry; the emitter itself is a template parameter of every
// kernel (kRounds), so a lane build and a grouped build of one arm share
// every line of the per-score code above and compute the same score for the
// same (query, row).
//
//   grouped (bin_w = 0 here): bin b of a tile = lane b of every 128-row group,
//     2 survivors per bin by the insertion network with strict `<` over the
//     groups in order (insert_group / store_tile above);
//   lane (K8): bin b = tile rows b*bin_w .. (b+1)*bin_w - 1, bin_w a multiple
//     of 128, `surv` (1 .. 8, a runtime argument) survivors per bin: the surv
//     smallest scores of the bin in (value, row) order -- the reference's
//     repeated min / first-argmin -- and the next value as the bin's bound.
//     Outputs per tile: cd / ci column j*n_bins + b for survivor j, padded
//     with +inf / INT32_MAX to out_w = round_up(n_bins*surv, 128) columns;
//     bounds column b, padded with +inf to bound_w = round_up(n_bins, 128).
//
// Lane design.  Every walk hands the emitter a group's scores in one layout:
// warp w holds query rows 4w .. 4w+3, and for each of them lane l holds the
// group's rows l + 32 j, j = 0 .. 3.  So one warp sees a query row's whole
// group, and a bin is bin_w / 128 consecutive groups.  Per query row the
// warp keeps the bin's running list of its surv + 1 smallest (value, row)
// pairs so far, one pair a lane (lane r holds the r-th).  At each group the
// warp merges that list with the group's 128 scores in surv + 1 rounds, all
// four query rows at once: each lane takes the smallest of its candidates
// (its list slot, then its 4 scores: rows in increasing order), one
// __reduce_min_sync (redux.sync) gives the warp's smallest order key, a
// second the smallest packed row among the lanes that hold it; the owner
// drops that candidate and lane r keeps round r's pair.  At the bin's last
// group lanes 0 .. surv - 1 write the survivors and lane surv the bound, in
// parallel.  The order key is an unsigned integer in the floats' order with
// -0 taken as +0 and NaN past +inf (order_key); the packed row carries the
// sign of a zero score, so the value written is bitwise the score's.  No
// per-thread list, no butterfly of shuffles, no lane writing alone.
// ---------------------------------------------------------------------------

constexpr int kMaxSurvivors = 8;                   // MAX_SURVIVORS
constexpr int kLaneRounds = kMaxSurvivors + 1;     // the lane merge's two builds
constexpr int kLaneRoundsSmall = kSurvivors + 1;

// The emitter build of a launch: 0 for grouped binning, else the lane
// merge's unrolled rounds for `surv` survivors.
__host__ inline int emit_rounds(int bin_w, int surv) {
  return bin_w == 0 ? 0 : surv + 1 <= kLaneRoundsSmall ? kLaneRoundsSmall
                                                       : kLaneRounds;
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The output geometry of one launch.
struct Geom {
  int bin_w;       // rows per bin; 0 = grouped binning
  int surv;        // survivors per bin
  int n_bins;      // bins per tile
  int out_w;       // candidate columns per tile
  int bound_w;     // bound columns per tile
  int bin_groups;  // 128-row groups per lane bin
};

// False for a geometry the kernels do not take: grouped runs two survivors;
// a lane bin is a multiple of 128 rows that divides the tile, with 1 .. 8
// survivors.
__host__ inline bool make_geom(int tile_n, int bin_w, int surv, Geom* g) {
  if (bin_w == 0) {
    *g = Geom{0, kSurvivors, kBinW, kSurvivors * kBinW, kBinW, 1};
    return surv == kSurvivors;
  }
  if (bin_w < kBinW || bin_w % kBinW || tile_n % bin_w || surv < 1 ||
      surv > kMaxSurvivors)
    return false;
  const int n_bins = tile_n / bin_w;
  *g = Geom{bin_w, surv, n_bins, round_up(n_bins * surv, kBinW),
            round_up(n_bins, kBinW), bin_w / kBinW};
  return true;
}

// Where a launch writes: the outputs, their rows and the geometry.
struct Out {
  float* cd;
  int* ci;
  float* bounds;
  int n_q;
  int n_tiles;
  int tile_n;
  Geom geo;
};

// The thread's place in the CTA: query rows q0 + quad*4 + i, lanes
// lane_col + 32*j of each group.
struct Place {
  int q0;
  int quad;
  int lane_col;
};

// kRounds = 0: grouped binning; kRounds > 0: lane binning, its merge
// unrolled over kRounds >= surv + 1 rounds.
template <int kRounds>
struct Emitter;

// Grouped binning: the insertion network of insert_group, stored per tile.
template <>
struct Emitter<0> {
  Vals vals;
  Gidx gidx;

  __device__ __forceinline__ void begin_tile() { reset_bins(vals, gidx); }

  __device__ __forceinline__ void group(const Acc& acc,
                                        const float* __restrict__ tnorm,
                                        size_t row0, int g, int, const Out&,
                                        const Place& p) {
    insert_group(vals, gidx, acc, tnorm, row0, p.lane_col, g);
  }

  __device__ __forceinline__ void end_tile(int ti, const Out& o,
                                           const Place& p, bool pad) {
    store_tile(vals, gidx, o.cd, o.ci, o.bounds, p.q0, p.quad, p.lane_col,
               o.n_q, o.n_tiles, ti, o.tile_n, pad);
  }
};

// The lane merge's order keys: kTaken marks a candidate already taken, an
// empty list slot and NaN (never selected before any other candidate).
constexpr unsigned kTaken = 0xFFFFFFFFu;
constexpr unsigned kKeyInf = 0xFF800000u;   // order_key(+inf)

// An unsigned key in the order of the floats: -0 takes +0's key (the two
// compare equal), NaN takes kTaken.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x);
  const unsigned k = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (b & 0x7FFFFFFFu) > 0x7F800000u ? kTaken
         : b == 0x80000000u              ? 0x80000000u
                                         : k;
}

// The score of a (key, packed row) pair: the key's float, -0 where the
// packed row's low bit says so, +inf past it (kTaken).
__device__ __forceinline__ float key_value(unsigned key, unsigned packed) {
  const float v = __uint_as_float((key & 0x80000000u) ? (key & 0x7FFFFFFFu)
                                                      : ~key);
  return key >= kKeyInf ? __int_as_float(0x7f800000)
         : (packed & 1u) ? -0.0f
                         : v;
}

// Lane binning (K8).
template <int kRounds>
struct Emitter {
  // per query row, slot `lane` of the bin's running list (lane <= surv):
  // its order key and its packed row (tile row << 1 | the sign of a zero)
  unsigned rk[kQuadQ];
  unsigned rp[kQuadQ];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i) rk[i] = rp[i] = kTaken;
  }

  __device__ __forceinline__ void begin_tile() { reset(); }

  // s = tnorm[t] - 2 qt for group g (tile rows g*128 + lane_col + 32*j),
  // merged with the running lists in surv + 1 rounds; at the bin's last
  // group, the writes.
  __device__ __forceinline__ void group(const Acc& acc,
                                        const float* __restrict__ tnorm,
                                        size_t row0, int g, int ti,
                                        const Out& o, const Place& p) {
    const int surv = o.geo.surv;
    const int lane = p.lane_col;
    unsigned key[kQuadQ][kQuadL], pk[kQuadQ][kQuadL];
#pragma unroll
    for (int j = 0; j < kQuadL; ++j) {
      const float tn = tnorm[row0 + lane + 32 * j];
      const unsigned row2 =
          static_cast<unsigned>(g * kBinW + lane + 32 * j) << 1;
#pragma unroll
      for (int i = 0; i < kQuadQ; ++i) {
        const float s = tn - 2.0f * acc[i][j];
        key[i][j] = order_key(s);
        pk[i][j] = row2 | (__float_as_uint(s) == 0x80000000u ? 1u : 0u);
      }
    }
    unsigned nk[kQuadQ], np[kQuadQ];
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i) nk[i] = np[i] = kTaken;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (r <= surv) {
        unsigned bk[kQuadQ], bp[kQuadQ];
#pragma unroll
        for (int i = 0; i < kQuadQ; ++i) {
          // the list slot's rows precede this group's; strict `<` keeps
          // the first of equal keys, the smallest row
          bk[i] = rk[i];
          bp[i] = rp[i];
#pragma unroll
          for (int j = 0; j < kQuadL; ++j) {
            const bool less = key[i][j] < bk[i];
            bk[i] = less ? key[i][j] : bk[i];
            bp[i] = less ? pk[i][j] : bp[i];
          }
        }
        unsigned mk[kQuadQ], mp[kQuadQ];
#pragma unroll
        for (int i = 0; i < kQuadQ; ++i)
          mk[i] = __reduce_min_sync(0xffffffffu, bk[i]);
#pragma unroll
        for (int i = 0; i < kQuadQ; ++i)
          mp[i] = __reduce_min_sync(0xffffffffu,
                                    bk[i] == mk[i] ? bp[i] : kTaken);
#pragma unroll
        for (int i = 0; i < kQuadQ; ++i) {
          // a real row is one candidate of the warp: its owner drops it
          rk[i] = rp[i] == mp[i] ? kTaken : rk[i];
#pragma unroll
          for (int j = 0; j < kQuadL; ++j)
            key[i][j] = pk[i][j] == mp[i] ? kTaken : key[i][j];
          nk[i] = lane == r ? mk[i] : nk[i];
          np[i] = lane == r ? mp[i] : np[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i) {
      rk[i] = nk[i];
      rp[i] = np[i];
    }
    if ((g + 1) % o.geo.bin_groups == 0) {
      write(g / o.geo.bin_groups, ti, o, p);
      reset();
    }
  }

  // Bin b's outputs: lane r < surv writes survivor r, lane surv the bound.
  __device__ __forceinline__ void write(int b, int ti, const Out& o,
                                        const Place& p) {
    const Geom& geo = o.geo;
    const int lane = p.lane_col;
    if (lane > geo.surv) return;
    const size_t cd_w = static_cast<size_t>(o.n_tiles) * geo.out_w;
    const size_t b_w = static_cast<size_t>(o.n_tiles) * geo.bound_w;
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i) {
      const int qrow = p.q0 + p.quad * 4 + i;
      if (qrow >= o.n_q) continue;
      const float v = key_value(rk[i], rp[i]);
      if (lane < geo.surv) {
        const size_t at = qrow * cd_w + static_cast<size_t>(ti) * geo.out_w +
                          lane * geo.n_bins + b;
        o.cd[at] = v;
        o.ci[at] = isfinite(v) ? ti * o.tile_n + static_cast<int>(rp[i] >> 1)
                               : INT32_MAX;
      } else {
        o.bounds[qrow * b_w + static_cast<size_t>(ti) * geo.bound_w + b] = v;
      }
    }
  }

  // The tile's padding columns: +inf / INT32_MAX past n_bins*surv, +inf
  // past n_bins.  (Lane binning has no fused form, so nothing is skipped.)
  __device__ __forceinline__ void end_tile(int ti, const Out& o,
                                           const Place& p, bool) {
    const Geom& geo = o.geo;
    const float inf = __int_as_float(0x7f800000);
    const size_t cd_w = static_cast<size_t>(o.n_tiles) * geo.out_w;
    const size_t b_w = static_cast<size_t>(o.n_tiles) * geo.bound_w;
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i) {
      const size_t qrow = p.q0 + p.quad * 4 + i;
      if (static_cast<int>(qrow) >= o.n_q) continue;
      for (int c = geo.n_bins * geo.surv + p.lane_col; c < geo.out_w; c += 32) {
        const size_t at = qrow * cd_w + static_cast<size_t>(ti) * geo.out_w + c;
        o.cd[at] = inf;
        o.ci[at] = INT32_MAX;
      }
      for (int c = geo.n_bins + p.lane_col; c < geo.bound_w; c += 32)
        o.bounds[qrow * b_w + static_cast<size_t>(ti) * geo.bound_w + c] = inf;
    }
  }
};

// K11's early-out (the fused entries of every f32 and int arm; the TPU's
// pallas_knn.py:722-828; binned_stream.cu states the rule and why it is
// sound).  Per (query, lane) a sorted carry of ``depth`` running minima of
// the tiles' lane minima, in thread-local memory.
__device__ __forceinline__ void reset_carry(
    float (&carry)[kQuadQ][kQuadL][kMaxCarry], int depth) {
#pragma unroll
  for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
    for (int j = 0; j < kQuadL; ++j)
#pragma unroll 1
      for (int d = 0; d < depth; ++d)
        carry[i][j][d] = __int_as_float(0x7f800000);
}

// At a tile's end: true when every real query row of the CTA's block has
// its tile minimum above thr (the largest lane's deepest carry value
// before this tile); the carry then takes the tile's lane minima.  depth
// = 0 skips nothing.  Every thread of the CTA calls it (a barrier).
__device__ __forceinline__ bool fused_skip(
    const Emitter<0>& em, float (&carry)[kQuadQ][kQuadL][kMaxCarry],
    int depth, const Place& p, int n_q, int* warp_ok) {
  if (depth == 0) return false;
  const float inf = __int_as_float(0x7f800000);
  float tmin[kQuadQ], thr[kQuadQ];
#pragma unroll
  for (int i = 0; i < kQuadQ; ++i) {
    tmin[i] = inf;
    thr[i] = -inf;
#pragma unroll
    for (int j = 0; j < kQuadL; ++j) {
      const float lane_min = em.vals[i][j][0];
      tmin[i] = fminf(tmin[i], lane_min);
      thr[i] = fmaxf(thr[i], carry[i][j][depth - 1]);
      // sorted insertion of the lane minimum into the carry
      float cur = lane_min;
#pragma unroll 1
      for (int d = 0; d < depth; ++d) {
        const float c = carry[i][j][d];
        carry[i][j][d] = fminf(c, cur);
        cur = fmaxf(c, cur);
      }
    }
  }
  bool ok = true;
#pragma unroll
  for (int i = 0; i < kQuadQ; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      tmin[i] = fminf(tmin[i], __shfl_xor_sync(0xffffffffu, tmin[i], off));
      thr[i] = fmaxf(thr[i], __shfl_xor_sync(0xffffffffu, thr[i], off));
    }
    ok = ok && (p.q0 + p.quad * 4 + i >= n_q || tmin[i] > thr[i]);
  }
  if (p.lane_col == 0) warp_ok[p.quad] = ok;
  __syncthreads();
  bool skip = true;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) skip = skip && warp_ok[w];
  return skip;
}

}  // namespace binned
