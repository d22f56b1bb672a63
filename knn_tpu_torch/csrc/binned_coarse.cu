// Fused bf16x3 distance + per-bin top-2 select + exclusion bound for Hopper
// (sm_90a).
//
// Replaces the TPU kernel knn_tpu/ops/pallas_knn.py::_bin_candidates (the
// tiled pallas_call, body _kernel in its bf16x3 arm, emitter
// _emit_select_grouped / _emit_select_grouped_scores, grouped binning,
// query-major grid).  It computes the same function, not the same block
// structure:
//
//   for every query row q and db row t of tile ti:
//     qh = bf16_rn(q), ql = bf16_rn(q - qh)                 (per element)
//     qt = sum_d qh*th + qh*tl + ql*th                      (f32 accumulate)
//     s  = tnorm[t] - 2*qt                                  (||q||^2 dropped)
//   bin b of tile ti = lane b of every 128-row group of the tile.  Per
//   (q, ti, b) keep the 2 smallest s with their group index through a
//   sorted insertion network with strict `<` (the earlier group wins a tie),
//   plus the third smallest as the bin's exclusion bound.  Two survivors are
//   part of the definition of a bin (with tile_n): the port runs no other value.
//
// Outputs, in the TPU kernel's exact layout:
//   cd     [n_q, n_tiles*256] f32  column ti*256 + j*128 + b (survivor j)
//   ci     [n_q, n_tiles*256] i32  ti*tile_n + g*128 + b, or INT32_MAX when
//                                  the value is not finite
//   bounds [n_q, n_tiles*128] f32  column ti*128 + b
//
// Design.  One CTA per (query block of 32 rows, db tile).  The CTA walks the
// tile's tile_n/128 column groups in ascending order.  For each group it
// stages 64-dim slices of the group's 128 db rows (th, tl upcast to f32) and
// of the query block (split into hi/lo parts in-kernel) in shared memory and
// accumulates the three products with CUDA-core FMAs.  bf16 products are
// exact in f32, so these FMAs give the products a bf16 tensor-core MMA with
// f32 accumulation gives.  Each of the 256 threads owns a 4-query x 4-lane
// register tile; after the group's last dim slice it forms s and runs the
// insertion network for its 16 (query, lane) bins in registers.  The
// [32, tile_n] score tile never exists anywhere.
//
// What bounds it on this card: operations.  The function is 3 bf16 products
// of 2*Q*Np*Dp FLOPs against ~1.2 GB of HBM traffic at the SIFT1M shape
// (Q=4096), so it sits far above the H100's bf16 ridge point.  This first
// version runs the products on the f32 FMA pipes (67 TFLOP/s, not the
// tensor cores' 989), so it is expected to run an order of magnitude above
// its bound; wgmma, TMA and a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBinW = 128;       // lanes per group = bins per tile
constexpr int kSurvivors = 2;    // candidates per bin
constexpr int kBlockQ = 32;      // query rows per CTA
constexpr int kThreads = 256;    // 8 query quads x 32 lane columns
constexpr int kDimSlice = 64;    // dims staged per shared-memory pass
constexpr int kQuadQ = 4;        // query rows per thread
constexpr int kQuadL = 4;        // lanes per thread (strided 32 apart)
constexpr int kDbStride = kDimSlice + 1;   // pad: conflict-free row reads
constexpr int kQStride = kBlockQ + 4;      // keeps float4 reads aligned

constexpr size_t kSmemBytes =
    sizeof(float) * (2 * kBinW * kDbStride + 2 * kDimSlice * kQStride);

__global__ void __launch_bounds__(kThreads, 2)
binned_select_bf16x3_kernel(const float* __restrict__ q,
                            const __nv_bfloat16* __restrict__ th,
                            const __nv_bfloat16* __restrict__ tl,
                            const float* __restrict__ tnorm,
                            float* __restrict__ cd, int* __restrict__ ci,
                            float* __restrict__ bounds, int n_q, int dp,
                            int n_tiles, int tile_n) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* ths = smem;                          // [128][kDbStride]
  float* tls = ths + kBinW * kDbStride;       // [128][kDbStride]
  float* qhs = tls + kBinW * kDbStride;       // [kDimSlice][kQStride]
  float* qls = qhs + kDimSlice * kQStride;    // [kDimSlice][kQStride]

  const int tid = threadIdx.x;
  const int lane_col = tid % 32;              // lanes lane_col + 32*j
  const int quad = tid / 32;                  // queries quad*4 + i
  const int ti = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int n_groups = tile_n / kBinW;
  const size_t tile_row0 = static_cast<size_t>(ti) * tile_n;

  float vals[kQuadQ][kQuadL][kSurvivors + 1];
  int gidx[kQuadQ][kQuadL][kSurvivors];
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

  for (int g = 0; g < n_groups; ++g) {
    const size_t row0 = tile_row0 + static_cast<size_t>(g) * kBinW;
    float acc[kQuadQ][kQuadL];
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
      for (int j = 0; j < kQuadL; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < dp; k0 += kDimSlice) {
      __syncthreads();  // previous slice fully consumed
      // db slice: 128 rows x 64 dims of th and tl, 8 bf16 per 16-byte load
#pragma unroll
      for (int p = 0; p < (kBinW * kDimSlice / 8) / kThreads; ++p) {
        const int idx = tid + p * kThreads;
        const int r = idx / (kDimSlice / 8);
        const int seg = idx % (kDimSlice / 8);
        const size_t off = (row0 + r) * static_cast<size_t>(dp) + k0 + seg * 8;
        const uint4 vh = *reinterpret_cast<const uint4*>(th + off);
        const uint4 vl = *reinterpret_cast<const uint4*>(tl + off);
        const __nv_bfloat16* bh = reinterpret_cast<const __nv_bfloat16*>(&vh);
        const __nv_bfloat16* bl = reinterpret_cast<const __nv_bfloat16*>(&vl);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ths[r * kDbStride + seg * 8 + e] = __bfloat162float(bh[e]);
          tls[r * kDbStride + seg * 8 + e] = __bfloat162float(bl[e]);
        }
      }
      // query slice: 32 rows x 64 dims, split into hi/lo bf16 parts with
      // round-to-nearest-even (JAX's astype), stored k-major for float4 reads
#pragma unroll
      for (int p = 0; p < (kBlockQ * kDimSlice / 4) / kThreads; ++p) {
        const int idx = tid + p * kThreads;
        const int r = idx / (kDimSlice / 4);
        const int c4 = idx % (kDimSlice / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + r < n_q)
          v = *reinterpret_cast<const float4*>(
              q + static_cast<size_t>(q0 + r) * dp + k0 + c4 * 4);
        const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat16 hi = __float2bfloat16_rn(xs[e]);
          const float hf = __bfloat162float(hi);
          const __nv_bfloat16 lo = __float2bfloat16_rn(xs[e] - hf);
          qhs[(c4 * 4 + e) * kQStride + r] = hf;
          qls[(c4 * 4 + e) * kQStride + r] = __bfloat162float(lo);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int k = 0; k < kDimSlice; ++k) {
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

    // s = tn - 2 qt, then the sorted insertion network (strict <)
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
        cd[row * out_w + col] = v;
        ci[row * out_w + col] =
            isfinite(v) ? ti * tile_n + gidx[i][j][s] * kBinW + lane
                        : INT32_MAX;
      }
      bounds[row * bound_w + static_cast<size_t>(ti) * kBinW + lane] =
          vals[i][j][kSurvivors];
    }
  }
}

cudaError_t launch(const float* q, const __nv_bfloat16* th,
                   const __nv_bfloat16* tl, const float* tnorm, float* cd,
                   int* ci, float* bounds, int n_q, int dp, int n_tiles,
                   int tile_n, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      binned_select_bf16x3_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (n_q + kBlockQ - 1) / kBlockQ);
  binned_select_bf16x3_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      q, th, tl, tnorm, cd, ci, bounds, n_q, dp, n_tiles, tile_n);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  Shapes: q [n_q, dp] f32; th, tl [n_tiles*tile_n, dp]
// bf16; tnorm [n_tiles*tile_n] f32 (row 0 of the [8, Np] norm rows); outputs
// as in the header.  dp must be a multiple of 128, tile_n a multiple of 128.
// Returns cudaGetLastError() after the launch (0 = launched); the wrapper
// raises on anything else.
extern "C" int binned_select_bf16x3(const void* q, const void* th,
                                    const void* tl, const void* tnorm,
                                    void* cd, void* ci, void* bounds, int n_q,
                                    int dp, int n_tiles, int tile_n,
                                    void* stream) {
  if (n_q <= 0 || n_tiles <= 0) return 0;
  return static_cast<int>(launch(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(th),
      static_cast<const __nv_bfloat16*>(tl), static_cast<const float*>(tnorm),
      static_cast<float*>(cd), static_cast<int*>(ci),
      static_cast<float*>(bounds), n_q, dp, n_tiles, tile_n,
      static_cast<cudaStream_t>(stream)));
}
