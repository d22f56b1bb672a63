// Fused distance + per-bin top-2 select + exclusion bound for Hopper (sm_90a):
// K1 (bf16x3) and K5 / K6 (the int8 and int4 arms), one CTA per (query
// block, db tile).
//
// Replaces the TPU kernel knn_tpu/ops/pallas_knn.py::_bin_candidates (the
// tiled pallas_call, body _kernel in its bf16x3, int8 and int4 arms,
// emitter _emit_select_grouped / _emit_select_grouped_scores, grouped
// binning, query-major grid).  It computes the same function, not the same
// block structure:
//
//   for every query row q and db row t of tile ti:
//     bf16x3: qh = bf16_rn(q), ql = bf16_rn(q - qh)          (per element)
//             qt = sum_d qh*th + qh*tl + ql*th               (f32 accumulate)
//     int8:   qt = (f32_rn(sum_d qi*ti) * qsc[q]) * ts[t]    (int32 exact)
//     int4:   the same, ti unpacked from nibbles: (b & 0xF) - 8 holds dim
//             c*128 + j, (b >> 4) - 8 dim c*128 + 64 + j of packed byte
//             c*64 + j
//     s  = tnorm[t] - 2*qt                                   (||q||^2 dropped)
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
// stages slices of the group's 128 db rows and of the query block in shared
// memory: bf16x3 64-dim slices upcast to f32 (the query split into hi/lo
// parts in-kernel), accumulated with CUDA-core FMAs (bf16 products are exact
// in f32, so these FMAs give the products a bf16 tensor-core MMA with f32
// accumulation gives); int8 / int4 one 128-dim chunk as 32-bit words of 4
// int8 dims (int4 unpacked on the way in), accumulated in int32 with
// __dp4a, then rescaled once.  Each of the 256 threads owns a 4-query x
// 4-lane register tile; after the group's last slice it forms s and runs
// the insertion network for its 16 (query, lane) bins in registers.  The
// [32, tile_n] score tile never exists anywhere.  The per-score arithmetic
// lives in binned_select.cuh, shared with the streaming kernels
// (binned_stream.cu).
//
// What bounds it on this card: operations.  bf16x3 is 3 bf16 products of
// 2*Q*Np*Dp FLOPs against ~1.2 GB of HBM traffic at the SIFT1M shape
// (Q=4096); int8 is one int8 product (Q*Np*Dp MACs) against ~0.8 GB (int4
// ~0.7 GB).  Both sit far above the H100's ridge points.  This first
// version runs them on CUDA cores (f32 FMA pipes at 67 TFLOP/s, __dp4a for
// the int arms), not the tensor cores (989 TFLOP/s bf16, 1,979 TOP/s int8),
// so it is expected to run an order of magnitude above its bound; wgmma /
// mma.sync s8, TMA and a persistent grid are later work.

#include "binned_select.cuh"

namespace {

using namespace binned;

constexpr int kDimSlice = 64;    // dims staged per shared-memory pass
constexpr int kDbStride = kDimSlice + 1;   // pad: conflict-free row reads

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

  Vals vals;
  Gidx gidx;
  reset_bins(vals, gidx);

  for (int g = 0; g < n_groups; ++g) {
    const size_t row0 = tile_row0 + static_cast<size_t>(g) * kBinW;
    Acc acc;
    zero_acc(acc);

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
      // query slice: 32 rows x 64 dims, split into hi/lo parts, stored
      // k-major for float4 reads
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
        for (int e = 0; e < 4; ++e)
          split_store(xs[e], qhs, qls, (c4 * 4 + e) * kQStride + r);
      }
      __syncthreads();
      fma_slice<kDimSlice, kDbStride>(ths, tls, qhs, qls, quad, lane_col, acc);
    }
    insert_group(vals, gidx, acc, tnorm, row0, lane_col, g);
  }
  store_tile(vals, gidx, cd, ci, bounds, q0, quad, lane_col, n_q, n_tiles, ti,
             tile_n, false);
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

// K5 / K6: the same walk over groups, one 128-dim int8 chunk per pass.
constexpr size_t kIntSmemInts =
    kBinW * kIntDbStride + kIntWords * kQStride;  // 21.5 KB, static

template <Arm kArm>
__global__ void __launch_bounds__(kThreads, 2)
binned_select_int_kernel(const int8_t* __restrict__ qi,
                         const float* __restrict__ qsc,
                         const uint8_t* __restrict__ t,
                         const float* __restrict__ aux,
                         float* __restrict__ cd, int* __restrict__ ci,
                         float* __restrict__ bounds, int n_q, int dp,
                         int n_tiles, int tile_n) {
  __shared__ __align__(16) int smem[kIntSmemInts];
  int* tws = smem;                                // [128][kIntDbStride]
  int* qws = smem + kBinW * kIntDbStride;         // [kIntWords][kQStride]

  const int tid = threadIdx.x;
  const int lane_col = tid % 32;              // lanes lane_col + 32*j
  const int quad = tid / 32;                  // queries quad*4 + i
  const int ti = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int n_groups = tile_n / kBinW;
  const size_t tile_row0 = static_cast<size_t>(ti) * tile_n;
  const size_t row_bytes = db_row_bytes<kArm>(dp);
  // aux: row norms [Np], then row scales [Np]
  const float* tnorm = aux;
  const float* tscale = aux + static_cast<size_t>(n_tiles) * tile_n;

  float qs[kQuadQ];
  load_qsc(qsc, q0, quad, n_q, qs);
  Vals vals;
  Gidx gidx;
  reset_bins(vals, gidx);

  for (int g = 0; g < n_groups; ++g) {
    const size_t row0 = tile_row0 + static_cast<size_t>(g) * kBinW;
    IAcc iacc;
    zero_iacc(iacc);
    for (int c0 = 0; c0 < dp; c0 += kDimChunk) {
      __syncthreads();  // previous chunk fully consumed
      stage_db_words<kArm>(t + row0 * row_bytes + db_row_bytes<kArm>(c0),
                           row_bytes, tws, tid);
      stage_q_words(qi + static_cast<size_t>(q0) * dp + c0, dp, n_q - q0,
                    qws, tid);
      __syncthreads();
      dp4a_chunk(tws, qws, quad, lane_col, iacc);
    }
    Acc acc;
    rescale(iacc, qs, tscale, row0, lane_col, acc);
    insert_group(vals, gidx, acc, tnorm, row0, lane_col, g);
  }
  store_tile(vals, gidx, cd, ci, bounds, q0, quad, lane_col, n_q, n_tiles, ti,
             tile_n, false);
}

template <Arm kArm>
cudaError_t launch_int(const void* qi, const void* qsc, const void* t,
                       const void* aux, void* cd, void* ci, void* bounds,
                       int n_q, int dp, int n_tiles, int tile_n,
                       cudaStream_t stream) {
  if (n_q <= 0 || n_tiles <= 0) return cudaSuccess;
  if (dp % kDimChunk) return cudaErrorInvalidValue;
  const dim3 grid(n_tiles, (n_q + kBlockQ - 1) / kBlockQ);
  binned_select_int_kernel<kArm><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(qi), static_cast<const float*>(qsc),
      static_cast<const uint8_t*>(t), static_cast<const float*>(aux),
      static_cast<float*>(cd), static_cast<int*>(ci),
      static_cast<float*>(bounds), n_q, dp, n_tiles, tile_n);
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

// C entries of K5 (int8) and K6 (int4) for ctypes.  Shapes: qi [n_q, dp]
// int8 and qsc [n_q] f32 (the quantized queries and their scales); t
// [n_tiles*tile_n, dp] int8 (K5) or [n_tiles*tile_n, dp/2] nibble-packed
// uint8 (K6); aux [2, n_tiles*tile_n] f32 (row norms, then row scales);
// outputs as K1's.  dp must be a multiple of 128.  Each returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int binned_select_int8(const void* qi, const void* qsc,
                                  const void* t, const void* aux, void* cd,
                                  void* ci, void* bounds, int n_q, int dp,
                                  int n_tiles, int tile_n, void* stream) {
  return static_cast<int>(launch_int<Arm::kInt8>(
      qi, qsc, t, aux, cd, ci, bounds, n_q, dp, n_tiles, tile_n,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int binned_select_int4(const void* qi, const void* qsc,
                                  const void* t, const void* aux, void* cd,
                                  void* ci, void* bounds, int n_q, int dp,
                                  int n_tiles, int tile_n, void* stream) {
  return static_cast<int>(launch_int<Arm::kInt4>(
      qi, qsc, t, aux, cd, ci, bounds, n_q, dp, n_tiles, tile_n,
      static_cast<cudaStream_t>(stream)));
}
