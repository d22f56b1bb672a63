// Device code shared by the bf16x3 binned-select kernels for Hopper (sm_90a):
// K1 (binned_coarse.cu, one CTA per query block and db tile) and K10/K11
// (binned_stream.cu, one CTA per query block walking a run of db tiles).
//
// Every kernel that includes this header computes each score with the same
// arithmetic, in the same order, so their outputs are bitwise equal:
//
//   qh = bf16_rn(q), ql = bf16_rn(q - qh)                  (split_store)
//   acc += qh*th; acc += qh*tl; acc += ql*th, dim by dim    (fma_slice)
//   s = tnorm[t] - 2*acc, then the strict-`<` insertion    (insert_group)
//   network that keeps 2 survivors + the bin bound
//
// The thread layout is fixed here too: a CTA of kThreads = 256 threads owns
// kBlockQ = 32 query rows and the 128 lanes of a column group; each thread
// owns a 4-query x 4-lane register tile (queries quad*4 + i, lanes
// lane_col + 32*j).  Shared-memory operands are f32: th/tl rows at a
// per-kernel row stride, query hi/lo parts k-major at kQStride.

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

using Vals = float[kQuadQ][kQuadL][kSurvivors + 1];
using Gidx = int[kQuadQ][kQuadL][kSurvivors];
using Acc = float[kQuadQ][kQuadL];

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
