// Fused distance + per-bin select + exclusion bound for Hopper (sm_90a): the
// tiled entries of every arm -- K1 (bf16x3), K4 (bf16x3f), K2 (highest), K3
// (default), K5 / K6 (int8, int4), K7 (pq) -- one CTA per (query block, db
// tile), in the query-major or (K9) the db-major grid, in grouped or (K8)
// lane binning.
//
// Replaces the TPU kernel knn_tpu/ops/pallas_knn.py::_bin_candidates (the
// tiled pallas_call, body _kernel in every arm, emitters _emit_select /
// _emit_select_grouped / _emit_select_grouped_scores, both binnings, both
// grid orders).  It computes the same function, not the same block
// structure (grouped binning shown; lane binning's bins and outputs are in
// binned_select.cuh, pq's scores too):
//
//   for every query row q and db row t of tile ti:
//     qt  = the arm's dot (binned_select.cuh: per-chunk f32 sums for the
//           f32 family, an exact int32 dot and one rescale for the int arms)
//     s   = tnorm[t] - 2*qt                                  (||q||^2 dropped)
//   bin b of tile ti = lane b of every 128-row group of the tile.  Per
//   (q, ti, b) keep the `surv` (1 .. 8; 2 by default) smallest s with their
//   group index through a sorted insertion network with strict `<` (the
//   earlier group wins a tie), plus the next smallest as the bin's
//   exclusion bound.
//
// Outputs, in the TPU kernel's exact layout (W = surv*128):
//   cd     [n_q, n_tiles*W] f32    column ti*W + j*128 + b (survivor j)
//   ci     [n_q, n_tiles*W] i32    ti*tile_n + g*128 + b, or INT32_MAX when
//                                  the value is not finite
//   bounds [n_q, n_tiles*128] f32  column ti*128 + b
//
// Design.  One CTA per (query block of 32 rows, db tile).  The CTA walks the
// tile's tile_n/128 column groups in ascending order.  Every arm but pq runs
// binned_mma.cuh's mainloop: each group's 128-dim chunks on the tensor
// cores -- bf16 for bf16x3 (K1), bf16x3f (K4) and default (K3), FP64 for
// highest (K2), s8 for int8 (K5) and int4 (K6) -- through a cp.async ring,
// the group's scores through a shared-memory tile into the emitter, which
// runs the insertion network (or the lane merge) for each thread's 16
// (query, lane) bins in registers (the deep grouped builds, surv != 2: 16,
// 8 or 4 of them a pass by the survivor count, the tile walked once per
// pass, binned_select.cuh); pq (K7) runs binned_pq.cuh's walk.  The
// [32, tile_n] score tile never exists anywhere.  The per-score arithmetic
// is the mainloop's and binned_select.cuh's, shared with the streaming
// kernels (binned_stream.cu).
//
// Grid order (K9).  The query-major grid is (n_tiles, query blocks):
// consecutive CTAs take consecutive db tiles for one query block.  The
// db-major grid (db_major = 1, the counterpart of pallas_knn.py:1135-1140)
// is (query blocks, n_tiles): consecutive CTAs share one db tile, so its
// rows are read from L2 by the CTAs in flight together.  Every CTA computes
// the same cells either way, so the outputs are bitwise equal.  The grid's
// y extent caps the query blocks (query-major) or the tiles (db-major) at
// 65,535.
//
// What bounds it on this card: the L2 reads of the db rows (binned_mma.cuh).
// By operations and HBM bytes alone every arm sits far above the H100's
// ridge points: bf16x3 and bf16x3f are 3 bf16 products of 2*Q*Np*Dp FLOPs,
// default one, against ~1.2 GB of HBM traffic at the SIFT1M shape
// (Q=4096); highest is one f64 product of the f32 values (the FP64 tensor
// cores' 67 TFLOP/s; 3xTF32 would not keep its proof, binned_mma.cuh);
// int8 is one int8 product (Q*Np*Dp MACs) against ~0.8 GB (int4 ~0.7 GB).
// But a 32-query CTA reads the db rows once per query block, so Q/32
// passes over the db go through L2 and set the time of every tensor-core
// arm.  pq's bound is its shared-memory lookups (binned_pq.cuh).

#include "binned_mma.cuh"
#include "binned_pq.cuh"

namespace {

using namespace binned;

constexpr int kMaxGridY = 65535;

// K1, K4, K2, K3, K5 and K6: every arm but pq on the tensor cores
// (binned_mma.cuh), one db tile per CTA.  kMulti: the build for Dp > 128
// (the query's chunk staged per step).
template <Arm kArm, bool kMulti, int kDepth>
__global__ void __launch_bounds__(kThreads, 1)
binned_select_mma_kernel(const void* __restrict__ p0,
                         const void* __restrict__ p1,
                         const void* __restrict__ p2,
                         const float* __restrict__ p3, Out out, int dp,
                         int db_major) {
  extern __shared__ float4 smem_f4[];
  __shared__ int warp_ok[kThreads / 32];
  const int ti = db_major ? blockIdx.y : blockIdx.x;
  const int q0 = (db_major ? blockIdx.x : blockIdx.y) * kBlockQ;
  mma_walk<kArm, kMulti, kDepth, false>(
      p0, p1, p2, p3, out, dp, q0, ti, ti + 1, 0,
      reinterpret_cast<unsigned char*>(smem_f4), warp_ok);
}

// K7: one db tile per CTA (binned_pq.cuh, pq_tiles).
template <int kDepth>
__global__ void __launch_bounds__(kThreads, 1)
binned_select_pq_kernel(const float* __restrict__ lut_t,
                        const uint8_t* __restrict__ codes_t,
                        const float* __restrict__ tnorm, Out out, int m,
                        int ncodes, int db_major) {
  extern __shared__ float4 smem_f4[];
  const int tid = threadIdx.x;
  const int ti = db_major ? blockIdx.y : blockIdx.x;
  const Place place{static_cast<int>(db_major ? blockIdx.x : blockIdx.y) *
                        kBlockQ,
                    tid / 32, tid % 32};
  pq_tiles<kDepth>(lut_t, codes_t, tnorm, out, place, m, ncodes, ti, ti + 1,
                  reinterpret_cast<unsigned char*>(smem_f4));
}

// The grid of one launch: (tiles, query blocks), or (query blocks, tiles)
// for db_major.  False when its y extent is past the cap.
bool grid_of(int n_q, int n_tiles, int db_major, dim3* grid) {
  const int q_blocks = (n_q + kBlockQ - 1) / kBlockQ;
  *grid = db_major ? dim3(q_blocks, n_tiles) : dim3(n_tiles, q_blocks);
  return static_cast<int>(grid->y) <= kMaxGridY;
}

template <Arm kArm, bool kMulti, int kDepth>
cudaError_t launch_mma(dim3 grid, const void* p0, const void* p1,
                       const void* p2, const void* p3, const Out& out, int dp,
                       int db_major, cudaStream_t stream) {
  constexpr size_t smem = kMmaSmemBytes<kArm, kMulti>;
  const cudaError_t err = cudaFuncSetAttribute(
      binned_select_mma_kernel<kArm, kMulti, kDepth>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  binned_select_mma_kernel<kArm, kMulti, kDepth>
      <<<grid, kThreads, smem, stream>>>(p0, p1, p2,
                                         static_cast<const float*>(p3), out,
                                         dp, db_major);
  return cudaGetLastError();
}

template <Arm kArm, int kDepth>
cudaError_t launch_arm(dim3 grid, const void* p0, const void* p1,
                       const void* p2, const void* p3, const Out& out, int dp,
                       int db_major, int ncodes, cudaStream_t stream) {
  if constexpr (kArm == Arm::kPq) {
    // dp = m, the code bytes per row
    const size_t smem = pq_smem_bytes(ncodes, kDepth);
    const cudaError_t err = cudaFuncSetAttribute(
        binned_select_pq_kernel<kDepth>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    binned_select_pq_kernel<kDepth><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(p0), static_cast<const uint8_t*>(p1),
        static_cast<const float*>(p3), out, dp, ncodes, db_major);
  } else {
    return dp > kDimChunk
               ? launch_mma<kArm, true, kDepth>(grid, p0, p1, p2, p3, out, dp,
                                                db_major, stream)
               : launch_mma<kArm, false, kDepth>(grid, p0, p1, p2, p3, out,
                                                 dp, db_major, stream);
  }
  return cudaGetLastError();
}

template <Arm kArm>
cudaError_t launch(const void* p0, const void* p1, const void* p2,
                   const void* p3, void* cd, void* ci, void* bounds, int n_q,
                   int dp, int n_tiles, int tile_n, int db_major, int bin_w,
                   int survivors, int ncodes, cudaStream_t stream) {
  if (n_q <= 0 || n_tiles <= 0) return cudaSuccess;
  dim3 grid;
  Out out{static_cast<float*>(cd), static_cast<int*>(ci),
          static_cast<float*>(bounds), n_q, n_tiles, tile_n, {}};
  if (!make_geom(tile_n, bin_w, survivors, &out.geo) ||
      !grid_of(n_q, n_tiles, db_major, &grid))
    return cudaErrorInvalidValue;
  if (kArm == Arm::kPq ? (dp < 1 || ncodes < 2 || ncodes > 256)
                       : dp % kDimChunk != 0)
    return cudaErrorInvalidValue;
  switch (emit_depth(bin_w, survivors)) {
    case 0:
      return launch_arm<kArm, 0>(grid, p0, p1, p2, p3, out, dp, db_major,
                                 ncodes, stream);
    case kGroupedDeep:
      return with_deep_build<kArm>(
          deep_depth<kArm>(survivors, tile_n), [&](auto build) {
            return launch_arm<kArm, decltype(build)::value>(
                grid, p0, p1, p2, p3, out, dp, db_major, ncodes, stream);
          });
    case kLaneDepthSmall:
      return launch_arm<kArm, kLaneDepthSmall>(grid, p0, p1, p2, p3, out, dp,
                                               db_major, ncodes, stream);
    default:
      return launch_arm<kArm, kLaneDepth>(grid, p0, p1, p2, p3, out, dp,
                                          db_major, ncodes, stream);
  }
}

// The resources of the tiled build a launch of arm kArm would take
// (binned_select.cuh kernel_attrs).
template <Arm kArm, int kDepth>
cudaError_t attrs_build(int dp, int ncodes, int* out) {
  if constexpr (kArm == Arm::kPq) {
    return kernel_attrs(binned_select_pq_kernel<kDepth>,
                        pq_smem_bytes(ncodes, kDepth), out);
  } else {
    if (dp > kDimChunk)
      return kernel_attrs(binned_select_mma_kernel<kArm, true, kDepth>,
                          kMmaSmemBytes<kArm, true>, out);
    return kernel_attrs(binned_select_mma_kernel<kArm, false, kDepth>,
                        kMmaSmemBytes<kArm, false>, out);
  }
}

// ... and the build of a launch at the binning (bin_w, survivors) on tiles
// of tile_n rows: its resources (out[0 .. 4]), its emitter code (out[5]:
// emit_depth's, a deep build's deep_code) and its passes a tile (out[6]).
template <Arm kArm>
cudaError_t attrs(int bin_w, int survivors, int dp, int ncodes, int tile_n,
                  int* out) {
  const int depth = emit_depth(bin_w, survivors);
  out[5] = depth;
  out[6] = 1;
  switch (depth) {
    case 0:
      return attrs_build<kArm, 0>(dp, ncodes, out);
    case kGroupedDeep:
      return with_deep_build<kArm>(
          deep_depth<kArm>(survivors, tile_n), [&](auto build) {
            constexpr int kBuild = decltype(build)::value;
            out[5] = kBuild;
            out[6] = deep_passes(kBuild);
            return attrs_build<kArm, kBuild>(dp, ncodes, out);
          });
    case kLaneDepthSmall:
      return attrs_build<kArm, kLaneDepthSmall>(dp, ncodes, out);
    default:
      return attrs_build<kArm, kLaneDepth>(dp, ncodes, out);
  }
}

}  // namespace

// The tiled build that binned_select_<arm> launches for the binning
// (bin_w, survivors) on tiles of tile_n rows at dp dims (pq: ncodes
// codes): out[0 .. 6] = registers a thread, static shared bytes, local
// bytes, dynamic shared bytes, CTAs per SM (binned_select.cuh
// kernel_attrs), the emitter build (0 two survivors, 3 / 9 the lane lists,
// a deep build's deep_code) and its passes a db tile.  Returns the
// cudaError (0 = out is set).
#define ATTRS_ENTRY(NAME, ARM)                                                \
  extern "C" int binned_select_attrs_##NAME(int bin_w, int survivors, int dp, \
                                            int ncodes, int tile_n,           \
                                            int* out) {                       \
    Geom geo;                                                                 \
    if (!make_geom(tile_n, bin_w, survivors, &geo))                           \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    return static_cast<int>(                                                  \
        attrs<ARM>(bin_w, survivors, dp, ncodes, tile_n, out));              \
  }

// C entries for ctypes, one per arm.  Operands p0 .. p3:
//   bf16x3, bf16x3f: q [n_q, dp] f32; th, tl [n_tiles*tile_n, dp] bf16;
//                    tnorm [n_tiles*tile_n] f32 (row 0 of the [8, Np] rows)
//   default:         q; th; unused; tnorm
//   highest:         q; t [n_tiles*tile_n, dp] f32; unused; tnorm
//   int8 / int4:     qi [n_q, dp] int8; qsc [n_q] f32 (the quantized
//                    queries and their scales); t [n_tiles*tile_n, dp] int8
//                    (K5) or [n_tiles*tile_n, dp/2] nibble-packed uint8
//                    (K6); aux [2, n_tiles*tile_n] f32 (row norms, then row
//                    scales)
//   pq (K7):         lut_t [ceil(n_q/32), dp, ncodes, 32] f32 (the LUT by
//                    query block and subspace, each slice [code][query],
//                    queries past n_q zero); codes_t [dp, n_tiles*tile_n]
//                    uint8 (subspace-major; dp = m, the subspaces; every
//                    code < ncodes); unused; tnorm (coarse_knn.
//                    _pq_kernel_operands lays them out)
// Outputs as in binned_select.cuh for the binning: bin_w = 0 is grouped
// binning with `survivors` (1 .. 8) per lane bin, bin_w > 0 lane binning
// with `survivors` (1 .. 8) per bin of bin_w rows (K8).  dp (but pq's) and tile_n must be
// multiples of 128; db_major picks the grid order (K9); ncodes is read by
// pq alone.  Each returns cudaGetLastError() after the launch (0 =
// launched; cudaErrorInvalidValue for a dim, geometry or grid it does not
// take); the wrapper raises on anything else.
#define TILED_ENTRY(NAME, ARM)                                                \
  extern "C" int binned_select_##NAME(                                        \
      const void* p0, const void* p1, const void* p2, const void* p3,         \
      void* cd, void* ci, void* bounds, int n_q, int dp, int n_tiles,         \
      int tile_n, int db_major, int bin_w, int survivors, int ncodes,         \
      void* stream) {                                                         \
    return static_cast<int>(launch<ARM>(p0, p1, p2, p3, cd, ci, bounds, n_q,  \
                                        dp, n_tiles, tile_n, db_major, bin_w, \
                                        survivors, ncodes,                    \
                                        static_cast<cudaStream_t>(stream)));  \
  }

#define ARM_ENTRIES(NAME, ARM) TILED_ENTRY(NAME, ARM) ATTRS_ENTRY(NAME, ARM)

// Each arm's entries are compiled apart (BINNED_PART = the Arm code; the
// whole source without it): ops/_cuda.py runs one nvcc per arm, all at
// once, and links them into one library.
#if BINNED_HAS_ARM(0)
ARM_ENTRIES(bf16x3, Arm::kBf16x3)

// One tensor-core k-step of the bf16x3 kernels on its own (the rounding
// probe of binned_mma.cuh's model): d = c + a . b^T, a [16][16] bf16, b
// [8][16] bf16, c and d [16][8] f32, row-major.  Returns cudaGetLastError()
// after the launch.
extern "C" int mma_probe_bf16(const void* a, const void* b, const void* c,
                              void* d, void* stream) {
  binned::mma_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<const float*>(c),
      static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}
#endif
#if BINNED_HAS_ARM(1)
ARM_ENTRIES(int8, Arm::kInt8)
#endif
#if BINNED_HAS_ARM(2)
ARM_ENTRIES(int4, Arm::kInt4)
#endif
#if BINNED_HAS_ARM(3)
ARM_ENTRIES(bf16x3f, Arm::kBf16x3f)
#endif
#if BINNED_HAS_ARM(4)
ARM_ENTRIES(highest, Arm::kHighest)

// One FP64 tensor-core k-step of the highest kernels on its own (the
// rounding probe of binned_mma.cuh's f64 step model): d = c + a . b^T, a
// [16][8] f64, b [8][8] f64, c and d [16][8] f64, row-major.  Returns
// cudaGetLastError() after the launch.
extern "C" int dmma_probe_f64(const void* a, const void* b, const void* c,
                              void* d, void* stream) {
  binned::dmma_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<const double*>(b),
      static_cast<const double*>(c), static_cast<double*>(d));
  return static_cast<int>(cudaGetLastError());
}
#endif
#if BINNED_HAS_ARM(5)
ARM_ENTRIES(default, Arm::kDefault)
#endif
#if BINNED_HAS_ARM(6)
ARM_ENTRIES(pq, Arm::kPq)
#endif
