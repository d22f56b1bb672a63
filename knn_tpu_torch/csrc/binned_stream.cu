// The db-streaming bf16x3 binned-select kernels for Hopper (sm_90a): K10
// (streaming) and K11 (fused early-out), two entries of one template.
//
// Replaces the TPU kernel knn_tpu/ops/pallas_knn.py::_stream_call (its
// pallas_call, body _stream_kernel, bf16x3 arm, grouped binning).  K10
// computes K1's function (binned_coarse.cu) with K1's per-score arithmetic
// (binned_select.cuh), so its (cd, ci, bounds) are bitwise equal to K1's.
// K11 is K10 plus the fused arm's early-out (pallas_knn.py:722-828):
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
//   unknown, or depth > MAX_CARRY_DEPTH = 8): nothing skips, output = K10's.
//
// Design.  Grid (segments, query blocks of 32 rows).  A CTA walks the db
// tiles of its segment in order, each tile's 128-row column groups in order,
// each group's dims in 32-dim steps.  Step t+1's raw operands (th, tl bf16
// rows and the f32 query slice) are copied into the second of two shared
// stages with cp.async while step t is converted (bf16 -> f32, query split
// into hi/lo) into the compute buffers and multiplied: the counterpart of the
// TPU kernel's make_async_copy double buffer.  Each tile's block goes
// straight to its own column offset in global memory.
//
// Occupancy.  At Q = 4096 there are only 128 query blocks of 32 rows for 132
// SMs, each of which holds 2 CTAs (84 KB of shared memory and 128 registers
// per thread each).  So the tile loop is split into contiguous segments, one
// per CTA: the wrapper (ops/coarse_knn.stream_segment_tiles) picks
// n_seg = min(n_tiles, floor(wave / query blocks)) segments, where wave =
// SMs x the CTAs per SM that stream_ctas_per_sm reads from the occupancy
// API for the built kernel (2 on an H100: 2 segments of 31 tiles, 256 CTAs,
// at the SIFT1M shape).  K10's output does not depend on the split.
//
// K11's skip depends on the query block and on the segment: each segment
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
// What bounds it on this card: operations, as K1: the three bf16 products
// run for every tile before the skip is decided, so the early-out saves only
// the skipped tile's output writes in this design, never the products.  The
// products run on the f32 FMA pipes (CUDA cores), an order of magnitude
// above the bf16 tensor-core bound; wgmma, TMA and a persistent grid are
// later work.

#include "binned_select.cuh"

namespace {

using namespace binned;

constexpr int kSlice = 32;                 // dims per pipeline step
constexpr int kDbStride = kSlice + 1;      // pad: conflict-free row reads
constexpr int kMaxCarry = 8;               // MAX_CARRY_DEPTH
constexpr int kRawDb = kBinW * kSlice;     // bf16 per part per stage
// one stage: th [128][32] bf16, tl [128][32] bf16, q [32][32] f32
constexpr size_t kStageBytes =
    2 * kRawDb * sizeof(__nv_bfloat16) + kBlockQ * kSlice * sizeof(float);
constexpr size_t kSmemBytes =
    2 * kStageBytes +
    sizeof(float) * (2 * kBinW * kDbStride + 2 * kSlice * kQStride);

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src_bytes < 16 zero-fills the rest (query rows past n_q)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copies of one step: db rows row0 .. row0+127 and query rows
// q0 .. q0+31, dims k0 .. k0+31.
__device__ __forceinline__ void start_stage(
    unsigned char* stage, const __nv_bfloat16* __restrict__ th,
    const __nv_bfloat16* __restrict__ tl, const float* __restrict__ q,
    size_t row0, int k0, int dp, int q0, int n_q, int tid) {
  __nv_bfloat16* sth = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* stl = sth + kRawDb;
  float* sq = reinterpret_cast<float*>(stl + kRawDb);
#pragma unroll
  for (int p = 0; p < (kRawDb / 8) / kThreads; ++p) {
    const int idx = tid + p * kThreads;
    const int r = idx / (kSlice / 8);
    const int seg = idx % (kSlice / 8);
    const size_t off = (row0 + r) * static_cast<size_t>(dp) + k0 + seg * 8;
    cp_async16(sth + r * kSlice + seg * 8, th + off, 16);
    cp_async16(stl + r * kSlice + seg * 8, tl + off, 16);
  }
  const int r = tid / (kSlice / 4);
  const int c4 = tid % (kSlice / 4);
  const bool live = q0 + r < n_q;
  const float* src =
      q + static_cast<size_t>(live ? q0 + r : 0) * dp + k0 + c4 * 4;
  cp_async16(sq + r * kSlice + c4 * 4, src, live ? 16 : 0);
}

// Stage -> compute buffers: th/tl upcast to f32 rows, the query slice split
// into hi/lo parts k-major (as K1 stages them from global memory).
__device__ __forceinline__ void convert_stage(const unsigned char* stage,
                                              float* ths, float* tls,
                                              float* qhs, float* qls,
                                              int tid) {
  const __nv_bfloat16* sth = reinterpret_cast<const __nv_bfloat16*>(stage);
  const __nv_bfloat16* stl = sth + kRawDb;
  const float* sq = reinterpret_cast<const float*>(stl + kRawDb);
#pragma unroll
  for (int p = 0; p < (kRawDb / 8) / kThreads; ++p) {
    const int idx = tid + p * kThreads;
    const int r = idx / (kSlice / 8);
    const int seg = idx % (kSlice / 8);
    const uint4 vh = *reinterpret_cast<const uint4*>(sth + r * kSlice + seg * 8);
    const uint4 vl = *reinterpret_cast<const uint4*>(stl + r * kSlice + seg * 8);
    const __nv_bfloat16* bh = reinterpret_cast<const __nv_bfloat16*>(&vh);
    const __nv_bfloat16* bl = reinterpret_cast<const __nv_bfloat16*>(&vl);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ths[r * kDbStride + seg * 8 + e] = __bfloat162float(bh[e]);
      tls[r * kDbStride + seg * 8 + e] = __bfloat162float(bl[e]);
    }
  }
  const int r = tid / (kSlice / 4);
  const int c4 = tid % (kSlice / 4);
  const float4 v = *reinterpret_cast<const float4*>(sq + r * kSlice + c4 * 4);
  const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_store(xs[e], qhs, qls, (c4 * 4 + e) * kQStride + r);
}

template <bool kFused>
__global__ void __launch_bounds__(kThreads, 2)
stream_select_kernel(const float* __restrict__ q,
                     const __nv_bfloat16* __restrict__ th,
                     const __nv_bfloat16* __restrict__ tl,
                     const float* __restrict__ tnorm, float* __restrict__ cd,
                     int* __restrict__ ci, float* __restrict__ bounds, int n_q,
                     int dp, int n_tiles, int tile_n, int seg_tiles,
                     int depth) {
  extern __shared__ float4 smem_f4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_f4);
  float* ths = reinterpret_cast<float*>(base + 2 * kStageBytes);
  float* tls = ths + kBinW * kDbStride;       // [128][kDbStride]
  float* qhs = tls + kBinW * kDbStride;       // [kSlice][kQStride]
  float* qls = qhs + kSlice * kQStride;       // [kSlice][kQStride]
  __shared__ int warp_ok[kThreads / 32];

  const int tid = threadIdx.x;
  const int lane_col = tid % 32;              // lanes lane_col + 32*j
  const int quad = tid / 32;                  // queries quad*4 + i
  const int q0 = blockIdx.y * kBlockQ;
  const int t_begin = blockIdx.x * seg_tiles;
  const int t_end = min(t_begin + seg_tiles, n_tiles);
  if (t_begin >= t_end) return;
  const int n_groups = tile_n / kBinW;
  const float inf = __int_as_float(0x7f800000);

  float carry[kQuadQ][kQuadL][kMaxCarry];
  if (kFused) {
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
      for (int j = 0; j < kQuadL; ++j)
#pragma unroll 1
        for (int d = 0; d < depth; ++d) carry[i][j][d] = inf;
  }

  // the next step to stage: (tile nt, group ng, dims nk)
  int nt = t_begin, ng = 0, nk = 0;
  auto stage_next = [&](unsigned char* stage) {
    start_stage(stage, th, tl, q,
                static_cast<size_t>(nt) * tile_n + static_cast<size_t>(ng) * kBinW,
                nk, dp, q0, n_q, tid);
    nk += kSlice;
    if (nk == dp) {
      nk = 0;
      if (++ng == n_groups) {
        ng = 0;
        ++nt;
      }
    }
  };
  stage_next(base);
  cp_async_commit();
  int buf = 0;

  Vals vals;
  Gidx gidx;
  for (int ti = t_begin; ti < t_end; ++ti) {
    reset_bins(vals, gidx);
    for (int g = 0; g < n_groups; ++g) {
      const size_t row0 =
          static_cast<size_t>(ti) * tile_n + static_cast<size_t>(g) * kBinW;
      Acc acc;
      zero_acc(acc);
      for (int k0 = 0; k0 < dp; k0 += kSlice) {
        // this step's stage has landed (every thread's copies) and the
        // previous step's compute buffers are consumed
        cp_async_wait_all();
        __syncthreads();
        // the other stage was last read by the previous step's conversion
        if (nt < t_end) stage_next(base + (buf ^ 1) * kStageBytes);
        cp_async_commit();
        convert_stage(base + buf * kStageBytes, ths, tls, qhs, qls, tid);
        __syncthreads();
        fma_slice<kSlice, kDbStride>(ths, tls, qhs, qls, quad, lane_col, acc);
        buf ^= 1;
      }
      insert_group(vals, gidx, acc, tnorm, row0, lane_col, g);
    }

    bool skip = false;
    if (kFused && depth > 0) {
      float tmin[kQuadQ], thr[kQuadQ];
#pragma unroll
      for (int i = 0; i < kQuadQ; ++i) {
        tmin[i] = inf;
        thr[i] = -inf;
#pragma unroll
        for (int j = 0; j < kQuadL; ++j) {
          const float lane_min = vals[i][j][0];
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
        ok = ok && (q0 + quad * 4 + i >= n_q || tmin[i] > thr[i]);
      }
      if (lane_col == 0) warp_ok[quad] = ok;
      __syncthreads();
      skip = true;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) skip = skip && warp_ok[w];
    }
    store_tile(vals, gidx, cd, ci, bounds, q0, quad, lane_col, n_q, n_tiles,
               ti, tile_n, skip);
  }
}

// Lets the kernel take kSmemBytes of dynamic shared memory (above the
// default 48 KB) on the current device.
template <bool kFused>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(stream_select_kernel<kFused>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmemBytes));
}

template <bool kFused>
cudaError_t ctas_per_sm(int* out) {
  cudaError_t err = allow_smem<kFused>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, stream_select_kernel<kFused>, kThreads, kSmemBytes);
}

template <bool kFused>
cudaError_t launch(const void* q, const void* th, const void* tl,
                   const void* tnorm, void* cd, void* ci, void* bounds,
                   int n_q, int dp, int n_tiles, int tile_n, int seg_tiles,
                   int depth, void* stream) {
  if (n_q <= 0 || n_tiles <= 0) return cudaSuccess;
  if (seg_tiles <= 0 || depth < 0 || depth > kMaxCarry || dp % kSlice)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<kFused>();
  if (err != cudaSuccess) return err;
  const dim3 grid((n_tiles + seg_tiles - 1) / seg_tiles,
                  (n_q + kBlockQ - 1) / kBlockQ);
  stream_select_kernel<kFused>
      <<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(th),
          static_cast<const __nv_bfloat16*>(tl),
          static_cast<const float*>(tnorm), static_cast<float*>(cd),
          static_cast<int*>(ci), static_cast<float*>(bounds), n_q, dp, n_tiles,
          tile_n, seg_tiles, depth);
  return cudaGetLastError();
}

}  // namespace

// C entries for ctypes.  Shapes as K1's (binned_coarse.cu): q [n_q, dp] f32;
// th, tl [n_tiles*tile_n, dp] bf16; tnorm [n_tiles*tile_n] f32 (row 0 of
// the [8, Np] norm rows); cd, ci [n_q, n_tiles*256]; bounds
// [n_q, n_tiles*128].  seg_tiles = db tiles per CTA (the last segment may
// be shorter); depth = K11's carry depth, 0..8 (0 disarms).  Each returns
// cudaGetLastError() after the launch (0 = launched); the wrapper raises on
// anything else.
extern "C" int stream_select_bf16x3(const void* q, const void* th,
                                    const void* tl, const void* tnorm,
                                    void* cd, void* ci, void* bounds, int n_q,
                                    int dp, int n_tiles, int tile_n,
                                    int seg_tiles, void* stream) {
  return static_cast<int>(launch<false>(q, th, tl, tnorm, cd, ci, bounds, n_q,
                                        dp, n_tiles, tile_n, seg_tiles, 0,
                                        stream));
}

extern "C" int fused_select_bf16x3(const void* q, const void* th,
                                   const void* tl, const void* tnorm, void* cd,
                                   void* ci, void* bounds, int n_q, int dp,
                                   int n_tiles, int tile_n, int seg_tiles,
                                   int depth, void* stream) {
  return static_cast<int>(launch<true>(q, th, tl, tnorm, cd, ci, bounds, n_q,
                                       dp, n_tiles, tile_n, seg_tiles, depth,
                                       stream));
}

// CTAs of K10 (fused = 0) or K11 (fused = 1) that one SM of the current
// device holds at once, from the occupancy API (registers, kThreads and
// kSmemBytes of the built kernel); the wrapper sizes the tile segments with
// it.  Returns the cudaError (0 = *out is set).
extern "C" int stream_ctas_per_sm(int fused, int* out) {
  return static_cast<int>(fused ? ctas_per_sm<true>(out)
                                : ctas_per_sm<false>(out));
}
