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
// order.  Every arm but pq runs binned_mma.cuh's mainloop over the run:
// (tile, group, 128-dim chunk) steps through a cp.async ring (step t+k's
// db rows copied while step t computes: the counterpart of the TPU
// kernel's make_async_copy double buffer), products on the tensor cores --
// the same code as the arm's tiled entry, so the same bits; pq (K7) runs
// binned_pq.cuh's walk over the run.  Each tile's block goes straight to
// its own column offset in global memory.
//
// Occupancy.  At Q = 4096 there are only 128 query blocks of 32 rows for 132
// SMs.  So the tile loop is split into contiguous segments, one per CTA: the
// wrapper (ops/coarse_knn.stream_segment_tiles) picks n_seg = min(n_tiles,
// floor(wave / query blocks)) segments, where wave = SMs x the CTAs per SM
// that stream_select_attrs_<arm> reads from the occupancy API for the built kernel
// of the arm (the mainloop's shared memory, binned_mma.cuh: 72-224 KB by
// arm and Dp, compiled for one CTA per SM; pq 194 KB at 256 codes, one).
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
// skipped tile's output writes in this design, never the products.  Every
// arm but pq runs on the tensor cores (binned_mma.cuh), bound by the L2
// reads of the db rows.

#include "binned_mma.cuh"
#include "binned_pq.cuh"

namespace {

using namespace binned;

// K7's streaming entry: the tiled walk (binned_pq.cuh, pq_tiles) over the
// CTA's segment of db tiles.
template <int kDepth>
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
  pq_tiles<kDepth>(lut_t, codes_t, tnorm, out, place, m, ncodes, t_begin, t_end,
                  reinterpret_cast<unsigned char*>(smem_f4));
}

// K10 / K11 and every other arm's streaming and fused entries but pq's: the
// arm on the tensor cores (binned_mma.cuh) over the CTA's segment of db
// tiles, K11's skip at each tile's end.
template <Arm kArm, bool kFused, bool kMulti, int kDepth>
__global__ void __launch_bounds__(kThreads, 1)
stream_select_mma_kernel(const void* __restrict__ p0,
                         const void* __restrict__ p1,
                         const void* __restrict__ p2,
                         const float* __restrict__ p3, Out out, int dp,
                         int seg_tiles, int depth) {
  extern __shared__ float4 smem_f4[];
  __shared__ int warp_ok[kThreads / 32];
  const int t_begin = blockIdx.x * seg_tiles;
  const int t_end = min(t_begin + seg_tiles, out.n_tiles);
  if (t_begin >= t_end) return;
  mma_walk<kArm, kMulti, kDepth, kFused>(
      p0, p1, p2, p3, out, dp, blockIdx.y * kBlockQ, t_begin, t_end, depth,
      reinterpret_cast<unsigned char*>(smem_f4), warp_ok);
}

// Lets the kernel take its dynamic shared memory (above the default 48 KB)
// on the current device.
template <Arm kArm, bool kFused, bool kMulti, int kDepth>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(
      stream_select_mma_kernel<kArm, kFused, kMulti, kDepth>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmaSmemBytes<kArm, kMulti>));
}

template <int kDepth>
cudaError_t allow_smem_pq(size_t smem) {
  return cudaFuncSetAttribute(stream_select_pq_kernel<kDepth>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <Arm kArm, bool kFused, bool kMulti, int kDepth>
cudaError_t launch_build(dim3 grid, const void* p0, const void* p1,
                         const void* p2, const void* p3, const Out& out,
                         int dp, int seg_tiles, int depth, int ncodes,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kArm == Arm::kPq) {
    const size_t smem = pq_smem_bytes(ncodes, kDepth);
    cudaError_t err = allow_smem_pq<kDepth>(smem);
    if (err != cudaSuccess) return err;
    stream_select_pq_kernel<kDepth><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(p0), static_cast<const uint8_t*>(p1),
        static_cast<const float*>(p3), out, dp, ncodes, seg_tiles);
  } else {
    cudaError_t err = allow_smem<kArm, kFused, kMulti, kDepth>();
    if (err != cudaSuccess) return err;
    stream_select_mma_kernel<kArm, kFused, kMulti, kDepth>
        <<<grid, kThreads, kMmaSmemBytes<kArm, kMulti>, st>>>(
            p0, p1, p2, static_cast<const float*>(p3), out, dp, seg_tiles,
            depth);
  }
  return cudaGetLastError();
}

template <Arm kArm, bool kFused, int kDepth>
cudaError_t launch_binning(dim3 grid, const void* p0, const void* p1,
                           const void* p2, const void* p3, const Out& out,
                           int dp, int seg_tiles, int depth, int ncodes,
                           void* stream) {
  if constexpr (kArm != Arm::kPq) {
    if (dp > kDimChunk)
      return launch_build<kArm, kFused, true, kDepth>(
          grid, p0, p1, p2, p3, out, dp, seg_tiles, depth, ncodes, stream);
  }
  return launch_build<kArm, kFused, false, kDepth>(
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
  const int slots = emit_depth(bin_w, survivors);
  if (slots == kGroupedDeep)
    return with_deep_build<kArm>(
        deep_depth<kArm>(survivors, tile_n), [&](auto build) {
          return launch_binning<kArm, kFused, decltype(build)::value>(
              grid, p0, p1, p2, p3, out, dp, seg_tiles, depth, ncodes,
              stream);
        });
  if constexpr (kFused) {
    return launch_binning<kArm, true, 0>(grid, p0, p1, p2, p3, out, dp,
                                         seg_tiles, depth, ncodes, stream);
  } else {
    switch (slots) {
      case 0:
        return launch_binning<kArm, false, 0>(grid, p0, p1, p2, p3, out, dp,
                                              seg_tiles, 0, ncodes, stream);
      case kLaneDepthSmall:
        return launch_binning<kArm, false, kLaneDepthSmall>(
            grid, p0, p1, p2, p3, out, dp, seg_tiles, 0, ncodes, stream);
      default:
        return launch_binning<kArm, false, kLaneDepth>(
            grid, p0, p1, p2, p3, out, dp, seg_tiles, 0, ncodes, stream);
    }
  }
}

// The resources of the streaming (kFused false) or fused build a launch of
// arm kArm would take (binned_select.cuh kernel_attrs).
template <Arm kArm, bool kFused, int kDepth>
cudaError_t attrs_build(int dp, int ncodes, int* out) {
  if constexpr (kArm == Arm::kPq) {
    if constexpr (kFused) return cudaErrorInvalidValue;
    else
      return kernel_attrs(stream_select_pq_kernel<kDepth>,
                          pq_smem_bytes(ncodes, kDepth), out);
  } else {
    if (dp > kDimChunk)
      return kernel_attrs(stream_select_mma_kernel<kArm, kFused, true, kDepth>,
                          kMmaSmemBytes<kArm, true>, out);
    return kernel_attrs(stream_select_mma_kernel<kArm, kFused, false, kDepth>,
                        kMmaSmemBytes<kArm, false>, out);
  }
}

// ... and the build of a launch at the binning (bin_w, survivors) on tiles
// of tile_n rows: its resources (out[0 .. 4]), its emitter code (out[5])
// and its passes a tile (out[6]), as binned_coarse.cu's attrs.
template <Arm kArm>
cudaError_t attrs(int fused, int bin_w, int survivors, int dp, int ncodes,
                  int tile_n, int* out) {
  const int slots = emit_depth(bin_w, survivors);
  out[5] = slots;
  out[6] = 1;
  if (slots == kGroupedDeep)
    return with_deep_build<kArm>(
        deep_depth<kArm>(survivors, tile_n), [&](auto build) {
          constexpr int kBuild = decltype(build)::value;
          out[5] = kBuild;
          out[6] = deep_passes(kBuild);
          return fused ? attrs_build<kArm, true, kBuild>(dp, ncodes, out)
                       : attrs_build<kArm, false, kBuild>(dp, ncodes, out);
        });
  if (fused) {
    if (slots > 0) return cudaErrorInvalidValue;
    return attrs_build<kArm, true, 0>(dp, ncodes, out);
  }
  switch (slots) {
    case 0:
      return attrs_build<kArm, false, 0>(dp, ncodes, out);
    case kLaneDepthSmall:
      return attrs_build<kArm, false, kLaneDepthSmall>(dp, ncodes, out);
    default:
      return attrs_build<kArm, false, kLaneDepth>(dp, ncodes, out);
  }
}

}  // namespace

// The streaming (fused = 0) or fused (fused = 1) build that
// stream_select_<arm> / fused_select_<arm> launch for the binning (bin_w,
// survivors) on tiles of tile_n rows at dp dims (pq: ncodes codes): out[0
// .. 6] as binned_coarse.cu's binned_select_attrs_<arm> reports its tiled
// builds'.  Returns the cudaError (0 = out is set).
#define ATTRS_ENTRY(NAME, ARM)                                                \
  extern "C" int stream_select_attrs_##NAME(int fused, int bin_w,             \
                                            int survivors, int dp,            \
                                            int ncodes, int tile_n,           \
                                            int* out) {                       \
    Geom geo;                                                                 \
    if (!make_geom(tile_n, bin_w, survivors, &geo))                           \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    return static_cast<int>(                                                  \
        attrs<ARM>(fused, bin_w, survivors, dp, ncodes, tile_n, out));       \
  }

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
// n_tiles*survivors*128] and [n_q, n_tiles*128]).  seg_tiles = db tiles per
// CTA (the last segment may be shorter); bin_w / survivors the binning
// (bin_w = 0: grouped; the fused entries are grouped only and take the
// survivors alone), 1 .. 8 survivors; depth = the fused kernel's carry
// depth, 0..8 (0 disarms); ncodes is read by pq alone.
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
      int tile_n, int seg_tiles, int depth, int survivors, void* stream) {    \
    return static_cast<int>(launch<ARM, true>(p0, p1, p2, p3, cd, ci, bounds, \
                                              n_q, dp, n_tiles, tile_n,       \
                                              seg_tiles, depth, 0, survivors, \
                                              0, stream));                    \
  }

#define STREAM_ENTRIES(NAME, ARM) \
  STREAM_ENTRY(NAME, ARM) FUSED_ENTRY(NAME, ARM) ATTRS_ENTRY(NAME, ARM)

// Each arm's entries are compiled apart (BINNED_PART, binned_select.cuh).
#if BINNED_HAS_ARM(0)
STREAM_ENTRIES(bf16x3, Arm::kBf16x3)
#endif
#if BINNED_HAS_ARM(1)
STREAM_ENTRIES(int8, Arm::kInt8)
#endif
#if BINNED_HAS_ARM(2)
STREAM_ENTRIES(int4, Arm::kInt4)
#endif
#if BINNED_HAS_ARM(3)
STREAM_ENTRIES(bf16x3f, Arm::kBf16x3f)
#endif
#if BINNED_HAS_ARM(4)
STREAM_ENTRIES(highest, Arm::kHighest)
#endif
#if BINNED_HAS_ARM(5)
STREAM_ENTRIES(default, Arm::kDefault)
#endif
#if BINNED_HAS_ARM(6)
STREAM_ENTRY(pq, Arm::kPq) ATTRS_ENTRY(pq, Arm::kPq)
#endif
