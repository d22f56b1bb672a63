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
//   (q, ti, b) keep the 2 smallest s with their group index through a
//   sorted insertion network with strict `<` (the earlier group wins a tie),
//   plus the third smallest as the bin's exclusion bound.  Two survivors are
//   part of the definition of a grouped bin (with tile_n): the port runs no
//   other value there.
//
// Outputs, in the TPU kernel's exact layout:
//   cd     [n_q, n_tiles*256] f32  column ti*256 + j*128 + b (survivor j)
//   ci     [n_q, n_tiles*256] i32  ti*tile_n + g*128 + b, or INT32_MAX when
//                                  the value is not finite
//   bounds [n_q, n_tiles*128] f32  column ti*128 + b
//
// Design.  One CTA per (query block of 32 rows, db tile).  The CTA walks the
// tile's tile_n/128 column groups in ascending order.  bf16x3 (K1), bf16x3f
// (K4) and highest (K2) run binned_mma.cuh's mainloop: each group's chunks
// on the tensor cores (bf16, or FP64 for highest) through a cp.async ring,
// its scores through a shared-memory tile into the emitter; pq (K7) runs
// binned_pq.cuh's walk.  The other arms stage slices of the group's 128 db
// rows and of the query block in shared memory and multiply them on CUDA
// cores: default 64-dim slices (th upcast to f32 and the query rounded to
// bf16 in-kernel), each 128-dim chunk summed in its own accumulator (chunk
// 0 in the score's own, later ones added into a running sum kept in shared
// memory), then added into the score; the int arms one 128-dim chunk as
// 32-bit words of 4 int8 dims (int4 unpacked on the way in), accumulated in
// int32 with __dp4a, then rescaled once.  Each of the
// 256 threads owns a 4-query x 4-lane register tile; after the group's last
// chunk it forms s and runs the insertion network for its 16 (query, lane)
// bins in registers.  The [32, tile_n] score tile never exists anywhere.
// The per-score arithmetic lives in binned_select.cuh, shared with the
// streaming kernels (binned_stream.cu).
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
// What bounds it on this card: operations.  bf16x3 and bf16x3f are 3 bf16
// products of 2*Q*Np*Dp FLOPs, default one, against ~1.2 GB of HBM traffic
// at the SIFT1M shape (Q=4096); highest is one f64 product of the f32
// values (the FP64 tensor cores' 67 TFLOP/s; 3xTF32 would not keep its
// proof, binned_mma.cuh); int8 is one int8 product (Q*Np*Dp MACs) against
// ~0.8 GB (int4 ~0.7 GB).  All sit far above the H100's ridge points.
// bf16x3, bf16x3f and highest run on the tensor cores (binned_mma.cuh: a
// 32-query CTA reads the db rows once per query block, so the L2 traffic,
// not the products, limits them); default and the int arms on CUDA cores
// (f32 FMA pipes at 67 TFLOP/s, __dp4a for the int arms), an order of
// magnitude above their bounds; their tensor-core forms (one bf16 MMA, s8
// MMA) are later work.  pq's bound is its shared-memory lookups
// (binned_pq.cuh).

#include "binned_mma.cuh"
#include "binned_pq.cuh"

namespace {

using namespace binned;

constexpr int kDimSlice = 64;    // dims staged per shared-memory pass
constexpr int kDbStride = kDimSlice + 1;   // pad: conflict-free row reads

constexpr size_t kComputeBytes = kF32ComputeBytes<kDimSlice>;   // 42,496 B
// dynamic shared memory of the single-chunk (Dp = 128) and the multi-chunk
// builds of the CUDA-core default kernel: the multi-chunk one adds the
// running sums
template <bool kMulti>
constexpr size_t kSmemBytes = kComputeBytes + (kMulti ? kRunBytes : 0);
constexpr int kMaxGridY = 65535;

// Stages dims k0 .. k0+63 of db rows row0 .. row0+127 and of query rows
// q0 .. q0+31 into the compute buffers: th upcast to f32, 8 bf16 per
// 16-byte load; the query's bf16 part k-major for 16-byte reads, rows past
// n_q as zeros.
__device__ __forceinline__ void stage_slice(
    const F32Bufs<kDimSlice, kDbStride>& bufs, const float* __restrict__ q,
    const __nv_bfloat16* __restrict__ th, size_t row0, int k0, int dp, int q0,
    int n_q, int tid) {
#pragma unroll
  for (int p = 0; p < (kBinW * kDimSlice / 8) / kThreads; ++p) {
    const int idx = tid + p * kThreads;
    const int r = idx / (kDimSlice / 8);
    const int seg = idx % (kDimSlice / 8);
    const size_t off = (row0 + r) * static_cast<size_t>(dp) + k0 + seg * 8;
    put_bf16x8(*reinterpret_cast<const uint4*>(th + off),
               bufs.db0 + r * kDbStride + seg * 8);
  }
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
      store_query(xs[e], bufs.qa, (c4 * 4 + e) * kQStride + r);
  }
}

// K3: the default arm on CUDA cores.  kMulti: the build for Dp > 128
// (sum_chunks).
template <bool kMulti, int kRounds>
__global__ void __launch_bounds__(kThreads, kCudaCoreCtas)
binned_select_f32_kernel(const float* __restrict__ q,
                         const __nv_bfloat16* __restrict__ th,
                         const float* __restrict__ tnorm, Out out, int dp,
                         int db_major) {
  extern __shared__ float4 smem_f4[];
  const F32Bufs<kDimSlice, kDbStride> bufs(smem_f4);
  // the multi-chunk build's running sums, after the compute buffers
  float* run = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(smem_f4) + kComputeBytes);

  const int tid = threadIdx.x;
  const int lane_col = tid % 32;              // lanes lane_col + 32*j
  const int quad = tid / 32;                  // queries quad*4 + i
  const int ti = db_major ? blockIdx.y : blockIdx.x;
  const int q0 = (db_major ? blockIdx.x : blockIdx.y) * kBlockQ;
  const int n_q = out.n_q;
  const int n_groups = out.tile_n / kBinW;
  const size_t tile_row0 = static_cast<size_t>(ti) * out.tile_n;
  const Place place{q0, quad, lane_col};

  Emitter<kRounds> em;
  em.begin_tile();

  for (int g = 0; g < n_groups; ++g) {
    const size_t row0 = tile_row0 + static_cast<size_t>(g) * kBinW;
    // the products of chunk c, summed into ``sum``
    auto chunk = [&](int c, Acc& sum) {
      for (int k0 = c * kDimChunk; k0 < (c + 1) * kDimChunk;
           k0 += kDimSlice) {
        __syncthreads();  // previous slice fully consumed
        stage_slice(bufs, q, th, row0, k0, dp, q0, n_q, tid);
        __syncthreads();
        slice_products(bufs, quad, lane_col, sum);
      }
    };
    Acc acc;
    sum_chunks<kMulti>(dp / kDimChunk, run, tid, chunk, acc);
    em.group(acc, tnorm, row0, g, ti, out, place);
  }
  em.end_tile(ti, out, place, false);
}

// K1, K4 and K2: the bf16x3, bf16x3f and highest arms on tensor cores
// (binned_mma.cuh), one db tile per CTA.  kMulti: the build for Dp > 128
// (the query's chunk staged per step).
template <Arm kArm, bool kMulti, int kRounds>
__global__ void __launch_bounds__(kThreads, 1)
binned_select_mma_kernel(const float* __restrict__ q,
                         const void* __restrict__ db0,
                         const void* __restrict__ db1,
                         const float* __restrict__ tnorm, Out out, int dp,
                         int db_major) {
  extern __shared__ float4 smem_f4[];
  __shared__ int warp_ok[kThreads / 32];
  const int ti = db_major ? blockIdx.y : blockIdx.x;
  const int q0 = (db_major ? blockIdx.x : blockIdx.y) * kBlockQ;
  mma_walk<kArm, kMulti, kRounds, false>(
      q, db0, db1, tnorm, out, dp, q0, ti, ti + 1, 0,
      reinterpret_cast<unsigned char*>(smem_f4), warp_ok);
}

// K5 / K6: the same walk over groups, one 128-dim int8 chunk per pass.
constexpr size_t kIntSmemInts =
    kBinW * kIntDbStride + kIntWords * kQStride;  // 21.5 KB, static

template <Arm kArm, int kRounds>
__global__ void __launch_bounds__(kThreads, kCudaCoreCtas)
binned_select_int_kernel(const int8_t* __restrict__ qi,
                         const float* __restrict__ qsc,
                         const uint8_t* __restrict__ t,
                         const float* __restrict__ aux, Out out, int dp,
                         int db_major) {
  __shared__ __align__(16) int smem[kIntSmemInts];
  int* tws = smem;                                // [128][kIntDbStride]
  int* qws = smem + kBinW * kIntDbStride;         // [kIntWords][kQStride]

  const int tid = threadIdx.x;
  const int lane_col = tid % 32;              // lanes lane_col + 32*j
  const int quad = tid / 32;                  // queries quad*4 + i
  const int ti = db_major ? blockIdx.y : blockIdx.x;
  const int q0 = (db_major ? blockIdx.x : blockIdx.y) * kBlockQ;
  const int n_q = out.n_q;
  const int n_groups = out.tile_n / kBinW;
  const size_t tile_row0 = static_cast<size_t>(ti) * out.tile_n;
  const size_t row_bytes = db_row_bytes<kArm>(dp);
  // aux: row norms [Np], then row scales [Np]
  const float* tnorm = aux;
  const float* tscale = aux + static_cast<size_t>(out.n_tiles) * out.tile_n;
  const Place place{q0, quad, lane_col};

  float qs[kQuadQ];
  load_qsc(qsc, q0, quad, n_q, qs);
  Emitter<kRounds> em;
  em.begin_tile();

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
    em.group(acc, tnorm, row0, g, ti, out, place);
  }
  em.end_tile(ti, out, place, false);
}

// K7: one db tile per CTA (binned_pq.cuh, pq_tiles).
template <int kRounds>
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
  pq_tiles<kRounds>(lut_t, codes_t, tnorm, out, place, m, ncodes, ti, ti + 1,
                  reinterpret_cast<unsigned char*>(smem_f4));
}

// The grid of one launch: (tiles, query blocks), or (query blocks, tiles)
// for db_major.  False when its y extent is past the cap.
bool grid_of(int n_q, int n_tiles, int db_major, dim3* grid) {
  const int q_blocks = (n_q + kBlockQ - 1) / kBlockQ;
  *grid = db_major ? dim3(q_blocks, n_tiles) : dim3(n_tiles, q_blocks);
  return static_cast<int>(grid->y) <= kMaxGridY;
}

template <Arm kArm, bool kMulti, int kRounds>
cudaError_t launch_f32(dim3 grid, const void* p0, const void* p1,
                       const void* p2, const void* p3, const Out& out, int dp,
                       int db_major, cudaStream_t stream) {
  if constexpr (kUsesMma<kArm>) {
    constexpr size_t smem = kMmaSmemBytes<kArm, kMulti>;
    const cudaError_t err = cudaFuncSetAttribute(
        binned_select_mma_kernel<kArm, kMulti, kRounds>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    binned_select_mma_kernel<kArm, kMulti, kRounds>
        <<<grid, kThreads, smem, stream>>>(static_cast<const float*>(p0), p1,
                                           p2, static_cast<const float*>(p3),
                                           out, dp, db_major);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        binned_select_f32_kernel<kMulti, kRounds>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes<kMulti>));
    if (err != cudaSuccess) return err;
    binned_select_f32_kernel<kMulti, kRounds>
        <<<grid, kThreads, kSmemBytes<kMulti>, stream>>>(
            static_cast<const float*>(p0),
            static_cast<const __nv_bfloat16*>(p1),
            static_cast<const float*>(p3), out, dp, db_major);
  }
  return cudaGetLastError();
}

template <Arm kArm, int kRounds>
cudaError_t launch_arm(dim3 grid, const void* p0, const void* p1,
                       const void* p2, const void* p3, const Out& out, int dp,
                       int db_major, int ncodes, cudaStream_t stream) {
  if constexpr (kArm == Arm::kPq) {
    // dp = m, the code bytes per row
    const size_t smem = pq_smem_bytes(ncodes);
    const cudaError_t err = cudaFuncSetAttribute(
        binned_select_pq_kernel<kRounds>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    binned_select_pq_kernel<kRounds><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(p0), static_cast<const uint8_t*>(p1),
        static_cast<const float*>(p3), out, dp, ncodes, db_major);
  } else if constexpr (kIsInt<kArm>) {
    binned_select_int_kernel<kArm, kRounds><<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(p0), static_cast<const float*>(p1),
        static_cast<const uint8_t*>(p2), static_cast<const float*>(p3), out,
        dp, db_major);
  } else {
    return dp > kDimChunk
               ? launch_f32<kArm, true, kRounds>(grid, p0, p1, p2, p3, out, dp,
                                               db_major, stream)
               : launch_f32<kArm, false, kRounds>(grid, p0, p1, p2, p3, out, dp,
                                                db_major, stream);
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
  switch (emit_rounds(bin_w, survivors)) {
    case 0:
      return launch_arm<kArm, 0>(grid, p0, p1, p2, p3, out, dp, db_major,
                                 ncodes, stream);
    case kLaneRoundsSmall:
      return launch_arm<kArm, kLaneRoundsSmall>(grid, p0, p1, p2, p3, out, dp,
                                               db_major, ncodes, stream);
    default:
      return launch_arm<kArm, kLaneRounds>(grid, p0, p1, p2, p3, out, dp,
                                          db_major, ncodes, stream);
  }
}

}  // namespace

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
// binning (survivors must be 2), bin_w > 0 lane binning with `survivors`
// (1 .. 8) per bin of bin_w rows (K8).  dp (but pq's) and tile_n must be
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

TILED_ENTRY(bf16x3, Arm::kBf16x3)
TILED_ENTRY(bf16x3f, Arm::kBf16x3f)
TILED_ENTRY(highest, Arm::kHighest)
TILED_ENTRY(default, Arm::kDefault)
TILED_ENTRY(int8, Arm::kInt8)
TILED_ENTRY(int4, Arm::kInt4)
TILED_ENTRY(pq, Arm::kPq)

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
