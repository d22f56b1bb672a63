// K7, the pq arm (pallas_knn.py:362-381, 443-452, 679-684), for every pq
// entry: the tiled one in either grid (binned_coarse.cu) and the streaming
// one (binned_stream.cu), each in grouped or (K8) lane binning.
//
//   qt[q, t] = sum over s = 0 .. m-1, in this order, of LUT[q, s*C + code[t, s]]
//              (f32 adds from 0, each rounded: __fadd_rn)
//   s        = tnorm[t] - 2*qt   (tnorm 0 on real rows, PAD_VAL on padding)
//
// then the grouped or the lane emitter.  The TPU kernel sums the same m
// products as a dense dot of the LUT with the codes' one-hot expansion; here
// the sum order is fixed, so every pq entry and its plain version
// (coarse_knn._pq_scores) give the same bits.
//
// Worst-case rounding, u = 2^-24, gamma_n = n u / (1 - n u).  On a real row
// t with codes c_s, t^ its reconstruction (t^_s = cb[s, c_s]), write T_s =
// ||q_s|| ||t^_s|| + ||t^_s||^2 / 2, so |LUT entry| <= T_s.  The prologue
// (coarse_knn.pq_luts: a dsub-term f32 dot, a dsub-term f32 norm, one
// subtraction) errs by <= gamma_{dsub+1} T_s per entry; this kernel's chain
// of m f32 adds from 0 by <= gamma_{m-1} sum_s |entry|.  So |qt - sum_s
// LUT_exact| <= gamma_{m+dsub} sum_s T_s, and s = 0 - 2 qt is exact after
// it: |s - s_pq| <= 2 gamma_{m+dsub} sum_s T_s <= gamma_{m+dsub} (||q||^2 +
// 2 ||t^||^2) <= gamma_{m+dsub} (||q||^2 + 2 (M + norm_err_max)), with
// sum_s T_s <= ||q|| ||t^|| + ||t^||^2 / 2 <= ||q||^2 / 2 + ||t^||^2 and
// ||t^||^2 <= M + norm_err_max (ops/pq.pq_bound_stats).  That is (m + dsub)
// u (||q||^2 + 2 M) to first order: 36 u at the default m = 32, dsub = 4,
// but 200 u at m = 196 (784 dims), over the reference certificate's whole
// f32 slack of 64 eps_f32 (||q||^2 + M) = 128 u (||q||^2 + M).  The port's
// certificate adds this term to the reference's ε (ops/pq.k7_rounding,
// score_error_bound_pq_t).
//
// Design.  A CTA of kThreads = 256 threads owns the kBlockQ = 32 queries of
// its block and walks its db tiles in row blocks of kPqRows = 1,024 rows
// (8 groups of 128; the tile's last block may be shorter).
//   - Queries on lanes: lane q of every warp is query q0 + q, and warp w
//     owns rows w*128 .. w*128+127 of the row block: 128 f32 accumulators a
//     thread, in registers across the block's m subspaces.
//   - Operands in the lookup's own layout (the wrapper's, coarse_knn.
//     _pq_kernel_operands): the LUT as [query block][s][C][32 queries] f32
//     (queries past n_q zero) and the codes subspace-major, [m][Np] uint8.
//     One subspace's step stages the block's LUT slice [C][32] (C*128 B,
//     contiguous) and the row block's codes of that subspace (1,024 B,
//     contiguous) with cp.async into one of two stages while the previous
//     subspace's lookups run: one barrier a subspace, none around the copy.
//   - Lookups: a warp reads 16 of its rows' codes with one 16-byte load,
//     the same address in every lane (a broadcast); lane q adds the word
//     at [code][q].  A warp's lookup is 32 consecutive words: one
//     wavefront, conflict-free whatever the codes are.  Four instructions
//     a lookup: the code's byte (PRMT), its address (one IMAD of code *
//     128 B onto the lane's base), the load and the add.
//   - Emission: at the row block's end each warp writes its accumulators
//     to the score tile S [32][1,025] f32 (row stride 1,025: lane q's
//     column writes fall in 32 different banks), and after one barrier the
//     emitters read S group by group in their own thread layout (queries
//     quad*4 + i, lanes lane_col + 32 j) into Emitter<kDepth>::group,
//     unchanged: grouped ties and the lane merge as in every other arm, a lane
//     score the grouped score of its row by construction.  A deep grouped
//     build (survivors other than 2, binned_select.cuh) walks each tile
//     once per pass, its emitter reading that pass's rows of S alone.
//
// Arithmetic per 4,096 queries x 1M rows x m = 32, C = 256 (Q*N*m = 1.31e11
// lookups; the bound is one shared-memory wavefront per warp lookup, 15.67
// ms on an H100 SXM):
//   - wavefronts per warp lookup: 1 for the LUT word, plus one 16-byte
//     broadcast of codes per 16 lookups;
//   - LUT bytes per lookup: a [C][32] slice (32 KB) serves 1,024 rows x 32
//     queries, 4 C / 1,024 = 1 B, 131 GB a call (a block is as many rows
//     as the registers hold accumulators for).  The query-major grid's
//     CTAs in flight share two or three query blocks, so the slices come
//     from L2; in the db-major grid and the streaming walk ~128 query
//     blocks' LUTs (1 MB each) are in flight, past the 50 MB L2, so from
//     HBM: >= 39 ms at 3.35 TB/s;
//   - codes bytes per lookup: 1 / 32 (1,024 rows x 1 B per 32,768 lookups);
//   - per CTA: 131,200 B of score tile + 2 x (128 C + 1,024) B of stages =
//     198,784 B of shared memory at C = 256 (lane builds add the lane
//     emitter's 16,896-B score tile); 128 accumulator registers a
//     thread beside the emitter's state (80 grouped, 6-18 lane), 254-255
//     registers in all: one CTA per SM.
// On an H100 SXM (700 W) at that shape the walk takes ~38 ms in the
// query-major grid, bound by its issue (four instructions a lookup, one
// CTA of 8 warps per SM), and ~45 ms in the db-major grid and the
// streaming walk, bound by the LUT slices' 131 GB from HBM.  Fewer LUT
// bytes a lookup (a cluster multicasting each slice to CTAs that share the
// query block) is the next step for those two.
// A tensor-core one-hot product, as the TPU runs it, costs 2*Q*N*m*C FLOPs
// -- far more.

#pragma once

#include "binned_mma.cuh"

namespace binned {

constexpr int kPqWarpRows = 128;                         // rows a warp owns
constexpr int kPqRows = kPqWarpRows * (kThreads / 32);   // rows a block
constexpr int kPqStride = kPqRows + 1;                   // f32 a row of S
constexpr size_t kPqScoreBytes = sizeof(float) * kBlockQ * kPqStride;
// bytes of one code's row [32 queries] of a LUT slice, as a shift
constexpr int kPqCodeShift = 7;
static_assert(sizeof(float) * kBlockQ == 1u << kPqCodeShift,
              "a LUT slice row is 128 bytes");

// Bytes of one stage: the LUT slice [C][32] f32, then the row block's
// codes of its subspace.
__host__ __device__ inline size_t pq_stage_bytes(int ncodes) {
  return sizeof(float) * kBlockQ * ncodes + kPqRows;
}

// Dynamic shared memory of a pq CTA: the score tile, two stages, then (lane
// binning, depth > 0) the lane emitter's tile.
__host__ __device__ inline size_t pq_smem_bytes(int ncodes, int depth) {
  return kPqScoreBytes + 2 * pq_stage_bytes(ncodes) +
         (depth > 0 ? kScoreTileBytes : 0);
}

// Starts the copies of one step: subspace s's LUT slice of query block qb
// and the codes of subspace s for rows rows0 .. rows0 + rows - 1 (rows a
// multiple of 128).
__device__ __forceinline__ void pq_start_stage(
    unsigned char* stage, const float* __restrict__ lut_t,
    const uint8_t* __restrict__ codes_t, size_t n_p, int qb, int m,
    int ncodes, int s, size_t rows0, int rows, int tid) {
  const float* src = lut_t + (static_cast<size_t>(qb) * m + s) *
                                 static_cast<size_t>(ncodes) * kBlockQ;
  float* dst = reinterpret_cast<float*>(stage);
  for (int i = tid; i < ncodes * kBlockQ / 4; i += kThreads)
    cp_async16(dst + 4 * i, src + 4 * i, 16);
  const uint8_t* csrc = codes_t + static_cast<size_t>(s) * n_p + rows0;
  unsigned char* cdst = stage + sizeof(float) * kBlockQ * ncodes;
  for (int i = tid; i < rows / 16; i += kThreads)
    cp_async16(cdst + 16 * i, csrc + 16 * i, 16);
}

// One subspace's lookups of this thread (query ``lane``, the warp's rows):
// acc[r] += LUT slice [code of row r][lane], r in order.  The entry's
// address is formed in bytes from the lane's base (one multiply-add, not an
// index scaled again).
__device__ __forceinline__ void pq_lookups(const unsigned char* stage,
                                           int ncodes, int warp, int lane,
                                           float (&acc)[kPqWarpRows]) {
  const unsigned char* lq = stage + sizeof(float) * lane;
  const uint4* cw = reinterpret_cast<const uint4*>(
      stage + sizeof(float) * kBlockQ * ncodes + warp * kPqWarpRows);
#pragma unroll
  for (int v = 0; v < kPqWarpRows / 16; ++v) {
    const uint4 x = cw[v];
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const unsigned code = __byte_perm(w[e / 4], 0u, 0x4440 + (e % 4));
      acc[v * 16 + e] = __fadd_rn(
          acc[v * 16 + e],
          *reinterpret_cast<const float*>(lq + (code << kPqCodeShift)));
    }
  }
}

// The pq arm over db tiles [t_begin, t_end) for the query block at p.q0:
// lut_t [n_blocks, m, ncodes, 32] f32, codes_t [m, n_tiles*tile_n] uint8,
// tnorm [n_tiles*tile_n] f32.
template <int kDepth>
__device__ __forceinline__ void pq_tiles(const float* __restrict__ lut_t,
                                         const uint8_t* __restrict__ codes_t,
                                         const float* __restrict__ tnorm,
                                         const Out& o, const Place& p,
                                         int m, int ncodes, int t_begin,
                                         int t_end, unsigned char* smem) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tile_n = o.tile_n;
  const size_t n_p = static_cast<size_t>(o.n_tiles) * tile_n;
  const int qb = p.q0 / kBlockQ;
  const int n_groups = tile_n / kBinW;
  constexpr int kGroups = kPqRows / kBinW;
  const int n_blocks = (n_groups + kGroups - 1) / kGroups;
  const size_t stage_bytes = pq_stage_bytes(ncodes);
  float* S = reinterpret_cast<float*>(smem);
  unsigned char* stages = smem + kPqScoreBytes;
  auto block_rows = [&](int b) {
    return min(kGroups, n_groups - b * kGroups) * kBinW;
  };

  // a deep grouped build walks each tile once per pass, kQuadQ / kPasses
  // rows of the threads' quads a pass (binned_select.cuh's build table):
  // every pass runs the tile's lookups again
  using Em = EmitterOf<kDepth>;
  constexpr bool kDeep = kDepth < 0;
  constexpr int kPasses = Em::kPasses;
  // the next step to stage: (tile nt, pass npass, row block nb, subspace ns)
  int nt = t_begin, npass = 0, nb = 0, ns = 0;
  auto stage_next = [&](unsigned char* st) {
    const size_t rows0 = static_cast<size_t>(nt) * tile_n +
                         static_cast<size_t>(nb) * kPqRows;
    pq_start_stage(st, lut_t, codes_t, n_p, qb, m, ncodes, ns, rows0,
                   block_rows(nb), tid);
    if (++ns == m) {
      ns = 0;
      if (++nb == n_blocks) {
        nb = 0;
        if (++npass == kPasses) {
          npass = 0;
          ++nt;
        }
      }
    }
  };
  stage_next(stages);
  cp_async_commit();
  int buf = 0;

  // lane binning: its tile after the stages
  Em em(reinterpret_cast<float*>(stages + 2 * stage_bytes));
  for (int ti = t_begin; ti < t_end; ++ti) {
    for (int pass = 0; pass < kPasses; ++pass) {
      em.begin_pass(pass);
      for (int b = 0; b < n_blocks; ++b) {
        const int rows = block_rows(b);
        const size_t rows0 = static_cast<size_t>(ti) * tile_n +
                             static_cast<size_t>(b) * kPqRows;
        const bool active = warp * kPqWarpRows < rows;
        float acc[kPqWarpRows];
#pragma unroll
        for (int r = 0; r < kPqWarpRows; ++r) acc[r] = 0.0f;
        for (int s = 0; s < m; ++s) {
          // this step's stage has landed (every thread's copies); the other
          // stage was last read by the previous step's lookups
          cp_async_wait_all();
          __syncthreads();
          if (nt < t_end) stage_next(stages + (buf ^ 1) * stage_bytes);
          cp_async_commit();
          if (active)
            pq_lookups(stages + buf * stage_bytes, ncodes, warp, lane, acc);
          buf ^= 1;
        }
        // S was last read by the previous block's emission, before this
        // block's first barrier
        if (active) {
#pragma unroll
          for (int r = 0; r < kPqWarpRows; ++r)
            S[lane * kPqStride + warp * kPqWarpRows + r] = acc[r];
        }
        __syncthreads();
        for (int gg = 0; gg < rows / kBinW; ++gg) {
          float tn[kQuadL];
          load_group_rows(tnorm, rows0 + static_cast<size_t>(gg) * kBinW,
                          p.lane_col, tn);
          if constexpr (kDeep) {
            // this pass's rows of the thread's quad
            float a[Em::kRows][kQuadL];
#pragma unroll
            for (int r = 0; r < Em::kRows; ++r)
#pragma unroll
              for (int j = 0; j < kQuadL; ++j)
                a[r][j] = tn[j] - 2.0f * S[(p.quad * kQuadQ +
                                            pass * Em::kRows + r) *
                                               kPqStride +
                                           gg * kBinW + p.lane_col + 32 * j];
            em.group_rows(a, b * kGroups + gg, o.geo.surv);
          } else {
            Acc a;
#pragma unroll
            for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
              for (int j = 0; j < kQuadL; ++j)
                a[i][j] = tn[j] - 2.0f * S[(p.quad * kQuadQ + i) * kPqStride +
                                           gg * kBinW + p.lane_col + 32 * j];
            em.group(a, b * kGroups + gg, ti, o, p);
          }
        }
      }
      em.end_pass(ti, o, p);
    }
    em.end_tile(ti, o, p, false);
  }
}

}  // namespace binned
