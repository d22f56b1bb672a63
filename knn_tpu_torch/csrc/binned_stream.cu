// The db-streaming binned-select kernels for Hopper (sm_90a), two entries
// of one template for each arm: streaming and fused early-out, for bf16x3
// (K10, K11), bf16x3f (K4), highest (K2), default (K3) and the int8 (K5)
// and int4 (K6) arms; the streaming entry of pq (K7, the walk of
// binned_pq.cuh over a segment of tiles, no fused form); every
// streaming entry in grouped or (K8) lane binning.
//
// Replaces the TPU kernel knn_tpu/ops/pallas_knn.py::_stream_call (its
// pallas_call, body _stream_kernel, every arm, both binnings).  The
// streaming kernel of an arm computes the tiled kernel's function
// (binned_coarse.cu) with its per-score arithmetic (binned_select.cuh), so
// its (cd, ci, bounds) are bitwise equal to the tiled kernel's of the same
// arm.  The fused kernel adds the fused arm's early-out
// (pallas_knn.py:722-828):
//
//   per (query, lane) a sorted carry of `depth` = ceil(keep/128) running
//   minima of the tiles' lane minima (a lane minimum is survivor 0 of its
//   bin, an emitted candidate).  At the end of each tile, per query row:
//     tile_min = min over lanes of this tile's lane minima
//     thr      = max over lanes of carry[depth-1]   (carry before this tile)
//   If every real query row of the CTA's block has tile_min > thr, the tile's
//   block is written as a skipped tile: cd +inf, ci INT32_MAX, bounds +inf.
//   The carry then takes this tile's lane minima (unconditionally; for a
//   skipped tile that is provably a no-op).  depth = 0 disarms it (keep
//   unknown, or depth > MAX_CARRY_DEPTH = 8): nothing skips, output = the
//   streaming kernel's.
//
// Design.  Grid (segments, query blocks of 32 rows).  A CTA walks the
// db tiles of its segment in order, each tile's 128-row column groups in
// order.  bf16x3 (K10, K11), bf16x3f (K4) and highest (K2) run
// binned_mma.cuh's mainloop over the run: (tile, group, 128-dim chunk)
// steps through a two-stage cp.async ring, products on the tensor cores --
// the same code as the arm's tiled entry, so the same bits; pq (K7) runs
// binned_pq.cuh's walk over the run.  default walks each group's dims in
// steps of 32 dims, int8 / int4 one 128-dim chunk.  Step t+1's raw
// operands (th and the f32 query slice; int: the int8 or packed int4 db
// rows and the int8 query slice) are copied into the second of two shared
// stages with cp.async while step t is converted (bf16 -> f32 and the
// query's bf16 part; int4 nibbles -> int8 words, int8 rows -> padded word
// rows) into the compute buffers and multiplied on CUDA cores: the
// counterpart of the TPU kernel's make_async_copy double buffer.  Each
// tile's block goes straight to its own column offset in global memory.
//
// Occupancy.  At Q = 4096 there are only 128 query blocks of 32 rows for 132
// SMs.  So the tile loop is split into contiguous segments, one per CTA: the
// wrapper (ops/coarse_knn.stream_segment_tiles) picks n_seg = min(n_tiles,
// floor(wave / query blocks)) segments, where wave = SMs x the CTAs per SM
// that stream_ctas_per_sm reads from the occupancy API for the built kernel
// of the arm (bf16x3, bf16x3f: 170 KB of shared memory, 202 KB above Dp =
// 128, one CTA per SM; highest 187 KB, 219 KB above, one; pq 194 KB at 256
// codes, one; default 45 KB, its multi-chunk build 16 KB more; int8 61 KB,
// int4 45 KB; default and the int arms are compiled for two CTAs per SM).
// The streaming output does not depend on the split.
//
// The fused skip depends on the query block and on the segment: each segment
// keeps its own carry, reset at its first tile.  That stays sound: the carry
// of a segment only holds lane minima its own tiles emitted (a skipped
// tile's minima never enter, see above), all of which stand in the final
// output row.  Every lane holds `depth` carry values <= thr, so the row has
// at least 128*depth >= keep emitted candidates <= thr: the final keep-th
// smallest candidate is <= thr.  A skipped tile's values are all > thr, so
// they could neither enter the top-keep nor bring the exclusion bound
// min(min bound, keep-th value) lower; padding them changes nothing after
// the exact top-(m+2) select (keep = m+2).  Query rows past n_q (zero rows
// of a ragged last block) take no part in the decision: they are not output.
//
// The carry lives in thread-local memory (L1 / L2), 16 (query, lane) slots x
// depth floats per thread, read and written once per tile.
//
// What bounds it on this card: as the tiled kernels.  The products run for
// every tile before the skip is decided, so the early-out saves only the
// skipped tile's output writes in this design, never the products.
// bf16x3's, bf16x3f's and highest's run on the tensor cores
// (binned_mma.cuh); default's and the int arms' on CUDA cores (f32 FMAs,
// __dp4a), an order of magnitude above the tensor-core bound.

#include "binned_mma.cuh"
#include "binned_pq.cuh"

namespace {

using namespace binned;

constexpr int kSlice = 32;                 // default's dims per step
constexpr int kDbStride = kSlice + 1;      // pad: conflict-free row reads
constexpr int kRawDb = kBinW * kSlice;     // db values per part per stage

// Per-arm pipeline geometry: dims per step, bytes of the db half of one
// cp.async stage, of the whole stage and of the compute buffers.
template <Arm kArm>
constexpr int kStep = kIsInt<kArm> ? kDimChunk : kSlice;

template <Arm kArm>
constexpr size_t kDbStage =
    kIsInt<kArm> ? kBinW * db_row_bytes<kArm>(kDimChunk)   // [128][chunk]
                 : kRawDb * sizeof(__nv_bfloat16);         // th

template <Arm kArm>
constexpr size_t kStageBytes =  // then the query rows [32][step]
    kDbStage<kArm> +
    (kIsInt<kArm> ? kBlockQ * kDimChunk : kBlockQ * kSlice * sizeof(float));

template <Arm kArm>
constexpr size_t kComputeBytes =
    kIsInt<kArm> ? sizeof(int) * (kBinW * kIntDbStride + kIntWords * kQStride)
                 : kF32ComputeBytes<kSlice>;

// ... and the running sums of the default kernel's multi-chunk build
// (Dp > 128, sum_chunks)
template <Arm kArm, bool kMulti>
constexpr size_t kSmemBytes =
    2 * kStageBytes<kArm> + kComputeBytes<kArm> + (kMulti ? kRunBytes : 0);

// The multi-chunk build holds as many CTAs per SM as the single-chunk one
// that stream_ctas_per_sm measures: registers bound both (kCudaCoreCtas),
// and kCudaCoreCtas CTAs with the running sums still fit an SM's 228 KB of
// shared memory (1 KB reserved per CTA).
static_assert(kCudaCoreCtas * (kSmemBytes<Arm::kDefault, true> + 1024) <=
                  228 * 1024,
              "the multi-chunk build would lose occupancy");

// Starts the default arm's copies of one step: th of db rows row0 ..
// row0+127 and the f32 query rows q0 .. q0+31, dims k0 .. k0+31.
__device__ __forceinline__ void start_stage(
    unsigned char* stage, const __nv_bfloat16* __restrict__ th,
    const float* __restrict__ q, size_t row0, int k0, int dp, int q0,
    int n_q, int tid) {
  __nv_bfloat16* sth = reinterpret_cast<__nv_bfloat16*>(stage);
#pragma unroll
  for (int p = 0; p < (kRawDb / 8) / kThreads; ++p) {
    const int idx = tid + p * kThreads;
    const int r = idx / (kSlice / 8);
    const int seg = idx % (kSlice / 8);
    const size_t off = (row0 + r) * static_cast<size_t>(dp) + k0 + seg * 8;
    cp_async16(sth + r * kSlice + seg * 8, th + off, 16);
  }
  float* sq = reinterpret_cast<float*>(stage + kDbStage<Arm::kDefault>);
  const int r = tid / (kSlice / 4);
  const int c4 = tid % (kSlice / 4);
  const bool live = q0 + r < n_q;
  const float* src =
      q + static_cast<size_t>(live ? q0 + r : 0) * dp + k0 + c4 * 4;
  cp_async16(sq + r * kSlice + c4 * 4, src, live ? 16 : 0);
}

// The int arms' copies of one step: the 128-dim chunk at k0 of db rows
// row0 .. row0+127 (int8 bytes, or packed int4 bytes) and of query rows
// q0 .. q0+31 (int8; rows past n_q are zero-filled).
template <Arm kArm>
__device__ __forceinline__ void start_stage_int(
    unsigned char* stage, const uint8_t* __restrict__ t,
    const int8_t* __restrict__ qi, size_t row0, int k0, int dp, int q0,
    int n_q, int tid) {
  constexpr int kChunkBytes = db_row_bytes<kArm>(kDimChunk);
  constexpr int kSegs = kChunkBytes / 16;
  const size_t row_bytes = db_row_bytes<kArm>(dp);
  unsigned char* sq = stage + kDbStage<kArm>;
#pragma unroll
  for (int p = 0; p < kBinW * kSegs / kThreads; ++p) {
    const int idx = tid + p * kThreads;
    const int r = idx / kSegs;
    const int seg = idx % kSegs;
    cp_async16(stage + r * kChunkBytes + seg * 16,
               t + (row0 + r) * row_bytes + db_row_bytes<kArm>(k0) + seg * 16,
               16);
  }
  const int r = tid / (kDimChunk / 16);
  const int seg = tid % (kDimChunk / 16);
  const bool live = q0 + r < n_q;
  const int8_t* src =
      qi + static_cast<size_t>(live ? q0 + r : 0) * dp + k0 + seg * 16;
  cp_async16(sq + r * kDimChunk + seg * 16, src, live ? 16 : 0);
}

// Stage -> compute buffers (as the tiled kernel stages from global memory):
// the staged th upcast to f32 rows; the query slice's bf16 part, k-major.
__device__ __forceinline__ void convert_stage(
    const unsigned char* stage, const F32Bufs<kSlice, kDbStride>& bufs,
    int tid) {
  const __nv_bfloat16* sth = reinterpret_cast<const __nv_bfloat16*>(stage);
#pragma unroll
  for (int p = 0; p < (kRawDb / 8) / kThreads; ++p) {
    const int idx = tid + p * kThreads;
    const int r = idx / (kSlice / 8);
    const int seg = idx % (kSlice / 8);
    put_bf16x8(*reinterpret_cast<const uint4*>(sth + r * kSlice + seg * 8),
               bufs.db0 + r * kDbStride + seg * 8);
  }
  const float* sq =
      reinterpret_cast<const float*>(stage + kDbStage<Arm::kDefault>);
  const int r = tid / (kSlice / 4);
  const int c4 = tid % (kSlice / 4);
  const float4 v = *reinterpret_cast<const float4*>(sq + r * kSlice + c4 * 4);
  const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    store_query(xs[e], bufs.qa, (c4 * 4 + e) * kQStride + r);
}

// The CUDA-core streaming and fused entries: default (K3) and the int arms
// (K5, K6).
template <Arm kArm, bool kFused, bool kMulti, int kRounds>
__global__ void __launch_bounds__(kThreads, kCudaCoreCtas)
stream_select_kernel(const void* __restrict__ p0,
                     const void* __restrict__ p1,
                     const void* __restrict__ p2,
                     const float* __restrict__ p3, Out out, int dp,
                     int seg_tiles, int depth) {
  static_assert(!(kFused && kRounds), "the fused early-out is grouped only");
  // operands: default (q f32, th bf16, unused, tnorm f32 [8, Np] row 0);
  // int8 / int4 (qi int8, qsc f32, t int8 or packed uint8, aux f32 [2,
  // Np]: row norms, then row scales)
  constexpr int kStepA = kStep<kArm>;
  constexpr size_t kStageA = kStageBytes<kArm>;
  extern __shared__ float4 smem_f4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_f4);
  // compute buffers after the two stages.  default: db rows at kDbStride,
  // then query values k-major (F32Bufs); int: db words at kIntDbStride,
  // then query words k-major
  void* cbuf = base + 2 * kStageA;
  const F32Bufs<kSlice, kDbStride> bufs(cbuf);
  int* tws = static_cast<int*>(cbuf);
  int* qws = tws + kBinW * kIntDbStride;      // [kIntWords][kQStride]
  // the running sums of the multi-chunk build (sum_chunks), after the
  // compute buffers
  float* run = reinterpret_cast<float*>(base + 2 * kStageA +
                                        kComputeBytes<kArm>);
  __shared__ int warp_ok[kThreads / 32];

  const int tid = threadIdx.x;
  const int lane_col = tid % 32;              // lanes lane_col + 32*j
  const int quad = tid / 32;                  // queries quad*4 + i
  const int q0 = blockIdx.y * kBlockQ;
  const int n_q = out.n_q;
  const int n_tiles = out.n_tiles;
  const int tile_n = out.tile_n;
  const Place place{q0, quad, lane_col};
  const int t_begin = blockIdx.x * seg_tiles;
  const int t_end = min(t_begin + seg_tiles, n_tiles);
  if (t_begin >= t_end) return;
  const int n_groups = tile_n / kBinW;
  const float* tnorm = p3;
  const float* tscale = p3 + static_cast<size_t>(n_tiles) * tile_n;
  float qs[kQuadQ];
  if constexpr (kIsInt<kArm>)
    load_qsc(static_cast<const float*>(p1), q0, quad, n_q, qs);

  float carry[kQuadQ][kQuadL][kMaxCarry];
  if constexpr (kFused) reset_carry(carry, depth);

  // the next step to stage: (tile nt, group ng, dims k0)
  int nt = t_begin, ng = 0, k0 = 0;
  auto stage_next = [&](unsigned char* stage) {
    const size_t row0 =
        static_cast<size_t>(nt) * tile_n + static_cast<size_t>(ng) * kBinW;
    if constexpr (kIsInt<kArm>)
      start_stage_int<kArm>(stage, static_cast<const uint8_t*>(p2),
                            static_cast<const int8_t*>(p0), row0, k0, dp, q0,
                            n_q, tid);
    else
      start_stage(stage, static_cast<const __nv_bfloat16*>(p1),
                  static_cast<const float*>(p0), row0, k0, dp, q0, n_q, tid);
    k0 += kStepA;
    if (k0 == dp) {
      k0 = 0;
      if (++ng == n_groups) {
        ng = 0;
        ++nt;
      }
    }
  };
  stage_next(base);
  cp_async_commit();
  int buf = 0;

  Emitter<kRounds> em;
  for (int ti = t_begin; ti < t_end; ++ti) {
    em.begin_tile();
    for (int g = 0; g < n_groups; ++g) {
      const size_t row0 =
          static_cast<size_t>(ti) * tile_n + static_cast<size_t>(g) * kBinW;
      // the next step's products summed into ``sum``
      auto step = [&](auto& sum) {
        // this step's stage has landed (every thread's copies) and the
        // previous step's compute buffers are consumed
        cp_async_wait_all();
        __syncthreads();
        // the other stage was last read by the previous step's conversion
        if (nt < t_end) stage_next(base + (buf ^ 1) * kStageA);
        cp_async_commit();
        const unsigned char* stage = base + buf * kStageA;
        if constexpr (kIsInt<kArm>) {
          stage_db_words<kArm>(stage, db_row_bytes<kArm>(kDimChunk), tws,
                               tid);
          stage_q_words(
              reinterpret_cast<const int8_t*>(stage + kDbStage<kArm>),
              kDimChunk, kBlockQ, qws, tid);
          __syncthreads();
          dp4a_chunk(tws, qws, quad, lane_col, sum);
        } else {
          convert_stage(stage, bufs, tid);
          __syncthreads();
          slice_products(bufs, quad, lane_col, sum);
        }
        buf ^= 1;
      };
      Acc acc;
      if constexpr (kIsInt<kArm>) {
        IAcc iacc;
        zero_iacc(iacc);
        for (int c0 = 0; c0 < dp; c0 += kStepA) step(iacc);
        rescale(iacc, qs, tscale, row0, lane_col, acc);
      } else {
        auto chunk = [&](int, Acc& sum) {
          for (int d = 0; d < kDimChunk; d += kStepA) step(sum);
        };
        sum_chunks<kMulti>(dp / kDimChunk, run, tid, chunk, acc);
      }
      em.group(acc, tnorm, row0, g, ti, out, place);
    }

    bool skip = false;
    if constexpr (kFused)
      skip = fused_skip(em, carry, depth, place, n_q, warp_ok);
    em.end_tile(ti, out, place, skip);
  }
}

// K7's streaming entry: the tiled walk (binned_pq.cuh, pq_tiles) over the
// CTA's segment of db tiles.
template <int kRounds>
__global__ void __launch_bounds__(kThreads, 1)
stream_select_pq_kernel(const float* __restrict__ lut_t,
                        const uint8_t* __restrict__ codes_t,
                        const float* __restrict__ tnorm, Out out, int m,
                        int ncodes, int seg_tiles) {
  extern __shared__ float4 smem_f4[];
  const int tid = threadIdx.x;
  const int t_begin = blockIdx.x * seg_tiles;
  const int t_end = min(t_begin + seg_tiles, out.n_tiles);
  if (t_begin >= t_end) return;
  const Place place{static_cast<int>(blockIdx.y) * kBlockQ, tid / 32,
                    tid % 32};
  pq_tiles<kRounds>(lut_t, codes_t, tnorm, out, place, m, ncodes, t_begin, t_end,
                  reinterpret_cast<unsigned char*>(smem_f4));
}

// K10 / K11 and K4's and K2's streaming and fused entries: the bf16x3,
// bf16x3f and highest arms on tensor cores (binned_mma.cuh) over the CTA's
// segment of db tiles, K11's skip at each tile's end.
template <Arm kArm, bool kFused, bool kMulti, int kRounds>
__global__ void __launch_bounds__(kThreads, 1)
stream_select_mma_kernel(const float* __restrict__ q,
                         const void* __restrict__ db0,
                         const void* __restrict__ db1,
                         const float* __restrict__ tnorm, Out out, int dp,
                         int seg_tiles, int depth) {
  extern __shared__ float4 smem_f4[];
  __shared__ int warp_ok[kThreads / 32];
  const int t_begin = blockIdx.x * seg_tiles;
  const int t_end = min(t_begin + seg_tiles, out.n_tiles);
  if (t_begin >= t_end) return;
  mma_walk<kArm, kMulti, kRounds, kFused>(
      q, db0, db1, tnorm, out, dp, blockIdx.y * kBlockQ, t_begin, t_end,
      depth, reinterpret_cast<unsigned char*>(smem_f4), warp_ok);
}

// The kernel of a build and its dynamic shared memory: the tensor-core
// kernel of bf16x3, bf16x3f and highest, or the CUDA-core one of default
// and the int arms.
template <Arm kArm, bool kFused, bool kMulti, int kRounds>
constexpr auto kernel_of() {
  if constexpr (kUsesMma<kArm>)
    return stream_select_mma_kernel<kArm, kFused, kMulti, kRounds>;
  else
    return stream_select_kernel<kArm, kFused, kMulti, kRounds>;
}

template <Arm kArm, bool kMulti>
constexpr size_t smem_of() {
  if constexpr (kUsesMma<kArm>)
    return kMmaSmemBytes<kArm, kMulti>;
  else
    return kSmemBytes<kArm, kMulti>;
}

// Lets the kernel take its dynamic shared memory (above the default 48 KB)
// on the current device.
template <Arm kArm, bool kFused, bool kMulti, int kRounds>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(kernel_of<kArm, kFused, kMulti, kRounds>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_of<kArm, kMulti>()));
}

template <int kRounds>
cudaError_t allow_smem_pq(size_t smem) {
  return cudaFuncSetAttribute(stream_select_pq_kernel<kRounds>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// CTAs per SM of the single-chunk build (the same for the multi-chunk one:
// one for the tensor-core arms, the static_assert above for default); pq's
// at its shared memory for ncodes codes (m unused).
template <Arm kArm, bool kFused, int kRounds>
cudaError_t ctas_per_sm(int m, int ncodes, int* out) {
  if constexpr (kArm == Arm::kPq) {
    const size_t smem = pq_smem_bytes(ncodes);
    cudaError_t err = allow_smem_pq<kRounds>(smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, stream_select_pq_kernel<kRounds>, kThreads, smem);
  } else {
    cudaError_t err = allow_smem<kArm, kFused, false, kRounds>();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel_of<kArm, kFused, false, kRounds>(), kThreads,
        smem_of<kArm, false>());
  }
}

template <Arm kArm, bool kFused, bool kMulti, int kRounds>
cudaError_t launch_build(dim3 grid, const void* p0, const void* p1,
                         const void* p2, const void* p3, const Out& out,
                         int dp, int seg_tiles, int depth, int ncodes,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kArm == Arm::kPq) {
    const size_t smem = pq_smem_bytes(ncodes);
    cudaError_t err = allow_smem_pq<kRounds>(smem);
    if (err != cudaSuccess) return err;
    stream_select_pq_kernel<kRounds><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(p0), static_cast<const uint8_t*>(p1),
        static_cast<const float*>(p3), out, dp, ncodes, seg_tiles);
  } else {
    cudaError_t err = allow_smem<kArm, kFused, kMulti, kRounds>();
    if (err != cudaSuccess) return err;
    if constexpr (kUsesMma<kArm>)
      stream_select_mma_kernel<kArm, kFused, kMulti, kRounds>
          <<<grid, kThreads, kMmaSmemBytes<kArm, kMulti>, st>>>(
              static_cast<const float*>(p0), p1, p2,
              static_cast<const float*>(p3), out, dp, seg_tiles, depth);
    else
      stream_select_kernel<kArm, kFused, kMulti, kRounds>
          <<<grid, kThreads, kSmemBytes<kArm, kMulti>, st>>>(
              p0, p1, p2, static_cast<const float*>(p3), out, dp, seg_tiles,
              depth);
  }
  return cudaGetLastError();
}

template <Arm kArm, bool kFused, int kRounds>
cudaError_t launch_binning(dim3 grid, const void* p0, const void* p1,
                           const void* p2, const void* p3, const Out& out,
                           int dp, int seg_tiles, int depth, int ncodes,
                           void* stream) {
  if constexpr (!kIsInt<kArm> && kArm != Arm::kPq) {
    if (dp > kDimChunk)
      return launch_build<kArm, kFused, true, kRounds>(
          grid, p0, p1, p2, p3, out, dp, seg_tiles, depth, ncodes, stream);
  }
  return launch_build<kArm, kFused, false, kRounds>(
      grid, p0, p1, p2, p3, out, dp, seg_tiles, depth, ncodes, stream);
}

template <Arm kArm, bool kFused>
cudaError_t launch(const void* p0, const void* p1, const void* p2,
                   const void* p3, void* cd, void* ci, void* bounds,
                   int n_q, int dp, int n_tiles, int tile_n, int seg_tiles,
                   int depth, int bin_w, int survivors, int ncodes,
                   void* stream) {
  if (n_q <= 0 || n_tiles <= 0) return cudaSuccess;
  Out out{static_cast<float*>(cd), static_cast<int*>(ci),
          static_cast<float*>(bounds), n_q, n_tiles, tile_n, {}};
  if (seg_tiles <= 0 || depth < 0 || depth > kMaxCarry ||
      !make_geom(tile_n, bin_w, survivors, &out.geo) || (kFused && bin_w))
    return cudaErrorInvalidValue;
  if (kArm == Arm::kPq ? (dp < 1 || ncodes < 2 || ncodes > 256)
                       : dp % kDimChunk != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((n_tiles + seg_tiles - 1) / seg_tiles,
                  (n_q + kBlockQ - 1) / kBlockQ);
  if constexpr (kFused) {
    return launch_binning<kArm, true, 0>(grid, p0, p1, p2, p3, out, dp,
                                         seg_tiles, depth, ncodes, stream);
  } else {
    switch (emit_rounds(bin_w, survivors)) {
      case 0:
        return launch_binning<kArm, false, 0>(grid, p0, p1, p2, p3, out, dp,
                                              seg_tiles, 0, ncodes, stream);
      case kLaneRoundsSmall:
        return launch_binning<kArm, false, kLaneRoundsSmall>(
            grid, p0, p1, p2, p3, out, dp, seg_tiles, 0, ncodes, stream);
      default:
        return launch_binning<kArm, false, kLaneRounds>(
            grid, p0, p1, p2, p3, out, dp, seg_tiles, 0, ncodes, stream);
    }
  }
}

template <bool kFused, int kRounds>
cudaError_t ctas_per_sm_of(int arm, int m, int ncodes, int* out) {
  switch (arm) {
#define ARM_CASE(ARM) \
  case static_cast<int>(ARM): return ctas_per_sm<ARM, kFused, kRounds>(m, ncodes, out);
    ARM_CASE(Arm::kBf16x3)
    ARM_CASE(Arm::kInt8)
    ARM_CASE(Arm::kInt4)
    ARM_CASE(Arm::kBf16x3f)
    ARM_CASE(Arm::kHighest)
    ARM_CASE(Arm::kDefault)
#undef ARM_CASE
    case static_cast<int>(Arm::kPq):
      if constexpr (kFused) return cudaErrorInvalidValue;
      else return ctas_per_sm<Arm::kPq, false, kRounds>(m, ncodes, out);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entries for ctypes.  Operands p0 .. p3 as the tiled entries of the same
// arm take them (binned_coarse.cu): f32 family q [n_q, dp] f32, then th, tl
// bf16 (bf16x3, bf16x3f), th and an unused pointer (default) or t f32 and
// an unused pointer (highest), then tnorm [n_tiles*tile_n] f32 (row 0 of
// the [8, Np] norm rows); int8 / int4 qi [n_q, dp] int8, qsc [n_q] f32, t
// [n_tiles*tile_n, dp] int8 or [n_tiles*tile_n, dp/2] packed uint8, aux
// [2, n_tiles*tile_n] f32; pq lut_t [ceil(n_q/32), dp, ncodes, 32] f32 and
// codes_t [dp, n_tiles*tile_n] uint8 (binned_coarse.cu states the
// layouts), an unused pointer, tnorm.  cd, ci, bounds as
// binned_select.cuh lays them out for the binning (grouped: [n_q,
// n_tiles*256] and [n_q, n_tiles*128]).  seg_tiles = db tiles per CTA (the
// last segment may be shorter); bin_w / survivors the binning (bin_w = 0:
// grouped, two survivors; the fused entries are grouped only); depth = the
// fused kernel's carry depth, 0..8 (0 disarms); ncodes is read by pq alone.
// Each returns cudaGetLastError() after the launch (0 = launched); the
// wrapper raises on anything else.
#define STREAM_ENTRY(NAME, ARM)                                               \
  extern "C" int stream_select_##NAME(                                        \
      const void* p0, const void* p1, const void* p2, const void* p3,         \
      void* cd, void* ci, void* bounds, int n_q, int dp, int n_tiles,         \
      int tile_n, int seg_tiles, int bin_w, int survivors, int ncodes,        \
      void* stream) {                                                         \
    return static_cast<int>(launch<ARM, false>(                               \
        p0, p1, p2, p3, cd, ci, bounds, n_q, dp, n_tiles, tile_n, seg_tiles,  \
        0, bin_w, survivors, ncodes, stream));                                \
  }

#define FUSED_ENTRY(NAME, ARM)                                                \
  extern "C" int fused_select_##NAME(                                         \
      const void* p0, const void* p1, const void* p2, const void* p3,         \
      void* cd, void* ci, void* bounds, int n_q, int dp, int n_tiles,         \
      int tile_n, int seg_tiles, int depth, void* stream) {                   \
    return static_cast<int>(launch<ARM, true>(p0, p1, p2, p3, cd, ci, bounds, \
                                              n_q, dp, n_tiles, tile_n,       \
                                              seg_tiles, depth, 0, 2, 0,      \
                                              stream));                       \
  }

#define STREAM_ENTRIES(NAME, ARM) STREAM_ENTRY(NAME, ARM) FUSED_ENTRY(NAME, ARM)

STREAM_ENTRIES(bf16x3, Arm::kBf16x3)
STREAM_ENTRIES(bf16x3f, Arm::kBf16x3f)
STREAM_ENTRIES(highest, Arm::kHighest)
STREAM_ENTRIES(default, Arm::kDefault)
STREAM_ENTRIES(int8, Arm::kInt8)
STREAM_ENTRIES(int4, Arm::kInt4)
STREAM_ENTRY(pq, Arm::kPq)

// CTAs of the streaming (fused = 0) or fused (fused = 1) kernel of arm
// `arm` (the Arm codes: 0 bf16x3, 1 int8, 2 int4, 3 bf16x3f, 4 highest, 5
// default, 6 pq) in grouped binning (bin_w = 0) or lane binning with
// `survivors` that one SM of the current device holds at once, from the
// occupancy API (registers, kThreads and the arm's shared memory -- pq's for
// m subspaces of ncodes codes -- of the built kernel); the wrapper sizes the
// tile segments with it.  Returns the cudaError (0 = *out is set).
extern "C" int stream_ctas_per_sm(int fused, int arm, int bin_w, int survivors,
                                  int m, int ncodes, int* out) {
  const int slots = emit_rounds(bin_w, survivors);
  if (fused)
    return static_cast<int>(slots ? cudaErrorInvalidValue
                                  : ctas_per_sm_of<true, 0>(arm, m, ncodes, out));
  switch (slots) {
    case 0:
      return static_cast<int>(ctas_per_sm_of<false, 0>(arm, m, ncodes, out));
    case kLaneRoundsSmall:
      return static_cast<int>(
          ctas_per_sm_of<false, kLaneRoundsSmall>(arm, m, ncodes, out));
    default:
      return static_cast<int>(
          ctas_per_sm_of<false, kLaneRounds>(arm, m, ncodes, out));
  }
}
