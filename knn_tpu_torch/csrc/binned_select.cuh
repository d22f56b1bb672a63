// Device code shared by every coarse kernel for Hopper (sm_90a): the tiled
// entries of every arm (binned_coarse.cu, one CTA per query block and db
// tile) and the streaming / fused entries of every arm (binned_stream.cu,
// one CTA per query block walking a run of db tiles): the arms' codes and
// thread layout and score tile, the int arms' nibble unpacking, both emitters
// (grouped and lane binning, K8), and K11's carry and skip, below.  Every
// arm but pq computes its scores on the tensor cores in one mainloop
// (binned_mma.cuh): bf16x3 (K1, K10, K11), bf16x3f (K4) and default (K3)
// on the bf16 ones, highest (K2) on the FP64 ones, int8 (K5) and int4 (K6)
// on the s8 ones; the pq arm's walk (K7) is binned_pq.cuh.
//
// Every kernel of one arm computes each score with the same arithmetic, in
// the same order, so the tiled, streaming and fused outputs of the arm are
// bitwise equal.  Per 128-dim chunk c of the padded dims (nd = Dp / 128
// chunks), the f32-family arms sum the chunk's products into a chunk
// accumulator zeroed at the chunk's start, and add the chunk into the
// score's running f32 sum at its end (acc = 0 + c_0 + c_1 + ...): the
// order of the TPU body, which adds each chunk's dot into its f32 scratch
// (knn_tpu/ops/pallas_knn.py:493-503).
//
//   bf16x3 (K1, K10, K11): qh.th + (qh.tl + ql.th) per chunk on tensor
//     cores, chunks added in f32
//   bf16x3f (K4): qh.th, qh.tl, ql.th of every k-step into one tensor-core
//     accumulator per chunk (the TPU's one dot over the 3x contraction
//     [qh|qh|ql].[th|tl|th], pallas_knn.py:407-414), chunks added in f32
//   highest (K2): q*t of the f32 values summed in f64 on the FP64 tensor
//     cores (mma m16n8k8), rounded once to f32 at the chunk's end, chunks
//     added in f32
//   default (K3): the TPU's one bf16 pass, qh.th (qh = bf16_rn(q), th =
//     bf16_rn(t)) in one tensor-core accumulator per chunk, 8 k-steps,
//     chunks added in f32
//   int8 (K5) / int4 (K6): qi . ti on the s8 tensor cores (mma m16n8k32)
//     into one int32 sum over every chunk (int4 rows are unpacked to int8
//     first, (b & 0xF) - 8 and (b >> 4) - 8: unpack_int4), then
//     acc = (f32_rn(dot) * qsc) * ts, each product rounded (binned_mma.cuh)
//   then s = tnorm[t] - 2*acc and the emitter: the strict-`<` insertion
//   network that keeps `surv` survivors (1 .. 8) + the bin bound
//   (grouped), or the lane merge (K8)
//
// The int dot is exact (|qi.ti| <= 128^2 dp fits int32 far past any
// real dim), so the one f32 rounding is the rescale's, in the TPU kernel's
// order (knn_tpu/ops/pallas_knn.py:475-476).
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
//   default.  No certificate tolerance (the reference refuses it in the
//     one-pass certificate; it serves the counted certificate, which does
//     not depend on the coarse pass's precision).  Against the exact sum of
//     its own products qh th, the tensor-core walk errs by <= (8 kappa + nd
//     - 1)(1 + 2^-7) u P (coarse_knn.accumulation_coefficient("default"):
//     8 k-steps of the step model into one accumulator, the nd - 1 chunk
//     adds), the plain version's f32 matmul by <= (128 + nd)(1 + 2^-7) u
//     P; so kernel and plain differ in s by <= (8 kappa + nd - 1 + 128 +
//     nd)(1 + 2^-7) + 4 times u (||q||^2 + M), both roundings of s
//     included: 456.5 u at Dp = 128 (coarse_knn.
//     kernel_plain_tolerance_scale; binned_mma.cuh gives the proof).
//     Against q t the one pass errs by up to (2^-7 + 2^-16) |q t| a dim
//     more, the arm's definition.
//
// The thread layout is fixed here too: a CTA of kThreads = 256 threads owns
// kBlockQ = 32 query rows and the 128 lanes of a column group; for the
// emitters each thread owns a 4-query x 4-lane tile of the group's scores
// (queries quad*4 + i, lanes lane_col + 32*j), read from the mainloop's
// shared score tile (the deep grouped builds: 1, 2 or 4 of the 4 queries a
// pass, below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace binned {

constexpr int kBinW = 128;       // lanes per group = bins per tile
constexpr int kSurvivors = 2;    // candidates per bin, the default build
constexpr int kBlockQ = 32;      // query rows per CTA
constexpr int kThreads = 256;    // 8 query quads x 32 lane columns
constexpr int kQuadQ = 4;        // query rows per thread
constexpr int kQuadL = 4;        // lanes per thread (strided 32 apart)
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

// A source compiled with BINNED_PART = an Arm code holds that arm's entries
// alone: ops/_cuda.py compiles the arms apart, all at once, and links them
// into the source's one library.
#ifdef BINNED_PART
#define BINNED_HAS_ARM(code) (BINNED_PART == (code))
#else
#define BINNED_HAS_ARM(code) 1
#endif

constexpr int kDimChunk = 128;            // dims per chunk (DIM_CHUNK)

template <Arm kArm>
constexpr bool kIsInt = kArm == Arm::kInt8 || kArm == Arm::kInt4;

using Vals = float[kQuadQ][kQuadL][kSurvivors + 1];
using Gidx = int[kQuadQ][kQuadL][kSurvivors];
using Acc = float[kQuadQ][kQuadL];

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

// One 32-bit word of 4 packed int4 bytes (chunk bytes j .. j+3) as the int8
// words of dims j .. j+3 (low nibbles) and 64+j .. 64+j+3 (high nibbles) of
// the chunk: the chunk-paired layout of knn_tpu_torch/ops/quantize.py
// pack_nibbles, biased +8.
__device__ __forceinline__ void unpack_int4(unsigned x, int& lo, int& hi) {
  lo = static_cast<int>(__vsub4(x & 0x0F0F0F0Fu, 0x08080808u));
  hi = static_cast<int>(__vsub4((x >> 4) & 0x0F0F0F0Fu, 0x08080808u));
}

// This thread's 4 values of a per-row array (the norm rows) for the group
// at db row row0: rows row0 + lane_col + 32*j.
__device__ __forceinline__ void load_group_rows(const float* __restrict__ src,
                                                size_t row0, int lane_col,
                                                float (&out)[kQuadL]) {
#pragma unroll
  for (int j = 0; j < kQuadL; ++j) out[j] = src[row0 + lane_col + 32 * j];
}

// Group g's scores s into the sorted insertion network with strict `<`:
// the earlier group wins a tie.
__device__ __forceinline__ void insert_group(Vals& vals, Gidx& gidx,
                                             const Acc& s, int g) {
#pragma unroll
  for (int j = 0; j < kQuadL; ++j) {
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i) {
      float cur_v = s[i][j];
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
// kernel (kDepth), so a lane build and a grouped build of one arm share
// every line of the per-score code above and compute the same score for the
// same (query, row).
//
//   grouped (bin_w = 0 here): bin b of a tile = lane b of every 128-row group,
//     `surv` survivors per bin by the insertion network with strict `<` over
//     the groups in order, the next value the bin's bound
//     (_emit_select_grouped_scores, pallas_knn.py:575-610).  Two builds:
//     surv = 2 (the default, Emitter<0>: insert_group / store_tile above,
//     all 16 of a thread's cells in registers, 80 registers) and the deep
//     builds for any other surv in 1 .. 8 (DeepEmitter, below: one to four
//     passes a tile by the survivor count).
//     Outputs per tile: cd / ci column j*128 + b for survivor j (out_w =
//     surv*128), bounds column b (bound_w = 128);
//   lane (K8): bin b = tile rows b*bin_w .. (b+1)*bin_w - 1, bin_w a multiple
//     of 128, `surv` (1 .. 8, a runtime argument) survivors per bin: the surv
//     smallest scores of the bin in (value, row) order -- the reference's
//     repeated min / first-argmin -- and the next value as the bin's bound.
//     Outputs per tile: cd / ci column j*n_bins + b for survivor j, padded
//     with +inf / INT32_MAX to out_w = round_up(n_bins*surv, 128) columns;
//     bounds column b, padded with +inf to bound_w = round_up(n_bins, 128).
//
// Lane design.  Every walk leaves a group's scores in a shared score tile
// [32 queries][128 rows] (q * kScoreStride + r): the tensor-core walk's S
// itself, read before the norms are applied (group_tile scores each read
// in the grouped path's order); K7's walk writes s into one (group).  Lane
// l of warp w takes query row 4w + l / 8 and 16 rows of the group
// (lane_row: 8 slots cover the 128 rows, each lane's in increasing order,
// the warp's 32 reads on 32 banks), so 8 lanes share a query row and each
// owns a slice of every group of the bin.  Each lane keeps the kDepth
// smallest (value, row) pairs of its slices so far in a sorted list, by
// the grouped emitter's insertion network with strict `<` (its rows arrive
// in increasing order, so the earlier row stays first on a tie).  At the
// bin's last group the 8 lanes of a query row merge their lists in 3
// butterfly steps of shuffles: each takes its partner's list, keeps the
// elementwise smaller of its own and the partner's reversed (the kDepth
// smallest of both, a half-cleaner of the bitonic merge), and sorts them
// (odd-even transposition); pairs compare by value, then row.  Lane e
// then holds entry e of the bin -- survivor e, or the bound for e == surv
// -- and gathers it over 8 consecutive bins, so each array gets whole
// 32-byte sectors, not a 4-byte store per bin.  Scores are compared as
// floats: -0 equals +0 (the row decides, as in the reference's
// first-argmin), and neither +inf nor NaN enters a list, so a bin short of
// finite scores writes +inf and INT32_MAX, as the reference writes a
// non-finite survivor; the value written is the score's own bits.  Per group a lane does 16 insertions and no warp-wide
// reduction, about the grouped emitter's work; the merge runs once a bin.
// ---------------------------------------------------------------------------

constexpr int kMaxSurvivors = 8;                   // MAX_SURVIVORS
constexpr int kLaneDepth = kMaxSurvivors + 1;      // the lane lists' two builds
constexpr int kLaneDepthSmall = kSurvivors + 1;
constexpr int kGroupedDeep = -1;                   // grouped, surv != 2

// The emitter build of a launch: 0 for grouped binning at two survivors,
// kGroupedDeep for grouped binning at any other count (then deep_depth,
// below, picks the deep build), else the lane lists' length for `surv`
// survivors.
__host__ inline int emit_depth(int bin_w, int surv) {
  if (bin_w == 0) return surv == kSurvivors ? 0 : kGroupedDeep;
  return surv + 1 <= kLaneDepthSmall ? kLaneDepthSmall : kLaneDepth;
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

// False for a geometry the kernels do not take: 1 .. 8 survivors, and a
// lane bin a multiple of 128 rows that divides the tile.
__host__ inline bool make_geom(int tile_n, int bin_w, int surv, Geom* g) {
  if (surv < 1 || surv > kMaxSurvivors) return false;
  if (bin_w == 0) {
    *g = Geom{0, surv, kBinW, surv * kBinW, kBinW, 1};
    return true;
  }
  if (bin_w < kBinW || bin_w % kBinW || tile_n % bin_w) return false;
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

// kDepth = 0: grouped binning at two survivors; kDepth > 0: lane binning,
// each lane's list kDepth >= surv + 1 long; kDepth < 0: the deep grouped
// builds (DeepEmitter, EmitterOf).  Every emitter walks each db tile in
// kPasses passes over its groups (one but some deep builds'), begin_pass
// before a pass, end_pass after it, end_tile after the last.
template <int kDepth>
struct Emitter;

// Grouped binning at two survivors: the insertion network of insert_group,
// stored per tile.
template <>
struct Emitter<0> {
  static constexpr int kPasses = 1;
  Vals vals;
  Gidx gidx;

  __device__ explicit Emitter(float*) {}

  __device__ __forceinline__ void begin_pass(int) { reset_bins(vals, gidx); }

  __device__ __forceinline__ void end_pass(int, const Out&, const Place&) {}

  // Group g's scores s = tn - 2 qt (queries quad*4 + i, rows lane_col +
  // 32*j of the group).
  __device__ __forceinline__ void group(const Acc& s, int g, int, const Out&,
                                        const Place&) {
    insert_group(vals, gidx, s, g);
  }

  __device__ __forceinline__ void end_tile(int ti, const Out& o,
                                           const Place& p, bool pad) {
    store_tile(vals, gidx, o.cd, o.ci, o.bounds, p.q0, p.quad, p.lane_col,
               o.n_q, o.n_tiles, ti, o.tile_n, pad);
  }
};

// The score tile of a group that the emitters read: f32 per (query q < 32
// of the block, row r < 128 of the group) at q * kScoreStride + r.  The
// stride keeps the tensor-core walk's fragment stores (binned_mma.cuh), the
// grouped emitter's reads (a warp's lanes on consecutive rows of one
// query) and the lane emitter's reads (lane_row) each on 32 banks.
constexpr int kScoreStride = kBinW + 4;
constexpr size_t kScoreTileBytes = sizeof(float) * kBlockQ * kScoreStride;

// Row ``k`` (0 .. 15, in increasing order) of the 16 a lane emitter thread
// reads, for slot = lane % 8: 32 (k / 4) + 16 (slot % 2) + 4 (k % 4) +
// slot / 2.  The 8 slots cover the group's 128 rows, and with 4 query rows
// a warp at kScoreStride = 4 (mod 32) its 32 lanes read 32 banks.
__device__ __forceinline__ int lane_row(int slot, int k) {
  return 32 * (k / 4) + 16 * (slot % 2) + 4 * (k % 4) + slot / 2;
}

// (va, ra) before (vb, rb) in the lane emitter's order: by value, then row.
__device__ __forceinline__ bool lane_before(float va, int ra, float vb,
                                            int rb) {
  return va < vb || (va == vb && ra < rb);
}

// Consecutive bins a lane's outputs are gathered over before they are
// written: 8 f32 = one 32-byte sector.
constexpr int kLaneVec = 8;

// ---------------------------------------------------------------------------
// The deep grouped build: grouped binning at surv = 1 .. 8 survivors but 2
// (the reference's any survivors up to MAX_SURVIVORS, _geometry:296-300,
// capped above).  It computes insert_group's network with `surv` slots:
// per cell -- one (query, lane) bin -- the surv smallest scores over the
// tile's groups with strict `<` (the earlier group wins a tie) and the next
// value as the bound, the same fminf / fmaxf / select steps in the same
// order, so its outputs are the plain version's (coarse_knn._select_tile)
// bit for bit.
//
// What sizes it.  A thread owns 16 cells (kQuadQ x kQuadL), the mainloop's
// ring takes the shared memory (up to 224 KB of 227), and the mainloop
// holds most of the 255 registers a thread may have: the two-survivor
// build keeps its 16 cells in 80 registers (3 values and 2 group indices a
// cell) at 240 registers in all for bf16x3, 255 for highest.  A cell at 8
// survivors with an int a group index takes 17 registers, 272 for 16 cells
// -- more than a thread has.  So each build keeps as many cells a pass as
// its state fits beside the mainloop with no spill, and walks each db tile
// once per pass: every pass recomputes the tile's products (and, in the
// query-major grid, re-reads the tile, from HBM once 132 tiles are in
// flight).  A build of four passes at every count (4x the products)
// took 3.7-4.9x the two-survivor entry; these take one or two below 257
// groups a tile.
//
// Group indices.  A tile of at most kPackedGroups = 256 groups (tile_n <=
// 32,768: the tuner's largest; the default is 16,384) numbers them in 8
// bits, so the packed builds keep the indices of a pass's cells four to a
// register, each read and written at a constant byte with __byte_perm
// (PRMT; the write predicated on the step's `less`, the read from the words
// as they were before the group): ceil(cells x slots / 4) registers.  A
// packed step costs ~1.6x an int one on an H100, the price of the
// registers it frees.
//
// The builds (deep_depth picks one on the host from surv and tile_n, after
// emit_depth; a build is (survivor slots, rows of the quad a pass, packed),
// its emitter code deep_code of them; registers as ptxas gives them for
// the tiled Dp = 128 builds, sm_90a, none spilling):
//
//   build  surv         slots rows packed  state a thread        passes
//   A      1            1     4    no      16 x (1 + 1 + 1) = 48  1
//   B      3            3     4    yes     16 x (3 + 1) + 12 = 76 1
//   B4     4            4     4    yes     16 x (4 + 1) + 16 = 96 1
//   C      5 .. 8       8     2    yes     8 x (8 + 1) + 16 = 88  2
//   W      3 .. 8,      8     1    no      4 x (8 + 8 + 1) = 68   4
//          > 256 groups
//
// highest and pq take C for 4 survivors too (B4 spills there: highest's
// f64 accumulators, pq's 128 accumulators a thread; pq's C, B, A and W
// hold 255 registers with no spill), and highest's deep builds sum their FP64
// products in four parts of one n-tile each (binned_mma.cuh dmma_chunk:
// 8 accumulator registers in place of 32; B and C spill otherwise).  A,
// B and B4 run their network for exactly their count; C and W branch
// once a group (surv is uniform) to the network compiled for the count,
// so no step past surv is issued.  A needs no packing (48 registers, under
// the two-survivor build's 80), so it takes any tile width; W is the
// four-pass build, one row of the quad a pass with int indices, kept for
// the geometry past 256 groups.  C's pass p takes rows 2p and 2p + 1 of the
// quad.  On an H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md) every tiled,
// db-major, streaming and fused entry at 1 and 3 survivors takes
// 0.85-1.28x its two-survivor entry, at 4 1.1-1.5x (highest and pq, C:
// 2.0-2.5x), at 8 2.1-2.65x for bf16x3, bf16x3f, highest and pq and
// 2.8-3.2x for default and the int arms, whose step costs are small
// beside the network's.
//
// A pass stores its rows' blocks at its end; a fused launch re-writes the
// whole block as a skipped tile's at the tile's end when the early-out
// skips it (the two-survivor build's carry and rule, fed each row's lane
// minima at the end of the pass that holds the row: at one pass, the
// two-survivor build's own order).
// ---------------------------------------------------------------------------

constexpr int kPackedGroups = 256;   // groups a tile of 8-bit indices holds

// A deep build's emitter code (a kDepth < 0): -(100 slots + 10 rows +
// packed), and its parts.
__host__ __device__ constexpr int deep_code(int slots, int rows,
                                            bool packed) {
  return -(100 * slots + 10 * rows + (packed ? 1 : 0));
}
__host__ __device__ constexpr int deep_slots(int code) { return -code / 100; }
__host__ __device__ constexpr int deep_rows(int code) {
  return -code / 10 % 10;
}
__host__ __device__ constexpr bool deep_packed(int code) {
  return -code % 10 == 1;
}
__host__ __device__ constexpr int deep_passes(int code) {
  return kQuadQ / deep_rows(code);
}

// The builds of the table above, by arm.
constexpr int kDeepOne = deep_code(1, kQuadQ, false);                 // A
template <Arm kArm>
constexpr int kDeepThree = deep_code(3, kQuadQ, true);                // B
template <Arm kArm>
constexpr int kDeepMany = deep_code(kMaxSurvivors, 2, true);          // C
template <Arm kArm>
constexpr int kDeepFour = kArm == Arm::kHighest || kArm == Arm::kPq
                              ? kDeepMany<kArm>
                              : deep_code(4, kQuadQ, true);           // B4
constexpr int kDeepWide = deep_code(kMaxSurvivors, 1, false);         // W

// The deep build a grouped launch of arm kArm at surv survivors (1 .. 8
// but 2) on tiles of tile_n rows takes.
template <Arm kArm>
__host__ constexpr int deep_depth(int surv, int tile_n) {
  if (surv == 1) return kDeepOne;
  if (tile_n / kBinW > kPackedGroups) return kDeepWide;
  if (surv == 3) return kDeepThree<kArm>;
  return surv == 4 ? kDeepFour<kArm> : kDeepMany<kArm>;
}

// f(std::integral_constant<int, code>()) for the deep build ``code`` of arm
// kArm: one instantiation per build the arm has.
template <Arm kArm, class F>
__host__ auto with_deep_build(int code, F&& f) {
  if (code == kDeepOne) return f(std::integral_constant<int, kDeepOne>());
  if (code == kDeepThree<kArm>)
    return f(std::integral_constant<int, kDeepThree<kArm>>());
  if (code == kDeepFour<kArm>)
    return f(std::integral_constant<int, kDeepFour<kArm>>());
  if (code == kDeepMany<kArm>)
    return f(std::integral_constant<int, kDeepMany<kArm>>());
  return f(std::integral_constant<int, kDeepWide>());
}

template <int kDepth>
struct DeepEmitter {
  static constexpr int kSlots = deep_slots(kDepth);
  static constexpr int kRows = deep_rows(kDepth);
  static constexpr bool kPacked = deep_packed(kDepth);
  static constexpr int kPasses = kQuadQ / kRows;
  static_assert(kSlots >= 1 && kSlots <= kMaxSurvivors &&
                    kQuadQ % kRows == 0,
                "not a deep build");
  // the build serves one count (A, B: every slot runs) or any up to 8 (C,
  // W: the slots past surv are predicated off)
  static constexpr bool kExact = kSlots < kMaxSurvivors;
  static constexpr int kIdx = kRows * kQuadL * kSlots;   // indices a pass
  static constexpr int kIdxWords = kPacked ? (kIdx + 3) / 4 : kIdx;
  float vals[kRows][kQuadL][kSlots];   // survivors, ascending
  float bnd[kRows][kQuadL];            // the bin bound
  unsigned idx[kIdxWords];             // the survivors' groups
  int pass;                            // rows pass*kRows .. of the quad
  float tmin[kQuadQ], thr[kQuadQ];     // fused: the rows' skip statistics

  __device__ explicit DeepEmitter(float*) {}

  // The group of slot k of cell (r, j) in the index words w: byte n % 4
  // of word n / 4 (packed), else word n, n = (r kQuadL + j) kSlots + k.
  static __device__ __forceinline__ unsigned gidx_in(
      const unsigned (&w)[kIdxWords], int r, int j, int k) {
    const int n = (r * kQuadL + j) * kSlots + k;
    if constexpr (kPacked)
      return __byte_perm(w[n / 4], 0u, 0x4440u + n % 4);
    else
      return w[n];
  }

  // ... set to g (< 256 when packed).
  __device__ __forceinline__ void set_gidx(int r, int j, int k, unsigned g) {
    const int n = (r * kQuadL + j) * kSlots + k;
    if constexpr (kPacked)   // byte n % 4 of g's byte 0, the rest kept
      idx[n / 4] = __byte_perm(idx[n / 4], g,
                               (0x3210u & ~(0xFu << 4 * (n % 4))) |
                                   (4u << 4 * (n % 4)));
    else
      idx[n] = g;
  }

  __device__ __forceinline__ void begin_pass(int p) {
    pass = p;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kQuadL; ++j) {
#pragma unroll
        for (int k = 0; k < kSlots; ++k)
          vals[r][j][k] = __int_as_float(0x7f800000);
        bnd[r][j] = __int_as_float(0x7f800000);
      }
#pragma unroll
    for (int w = 0; w < kIdxWords; ++w) idx[w] = 0;
  }

  // Group g's scores s[r][j] of this pass's rows into the network with
  // kActive slots: insert_group's steps, cell by cell.  A slot's old group
  // is read from the words as they were before the group (no step writes
  // another slot's byte), so the reads wait on no write and the writes of
  // a packed word chain beside the values' steps, not in front of them.
  template <int kActive>
  __device__ __forceinline__ void insert_rows(const float (&s)[kRows][kQuadL],
                                              int g) {
    unsigned before[kIdxWords];
#pragma unroll
    for (int w = 0; w < kIdxWords; ++w) before[w] = idx[w];
#pragma unroll
    for (int j = 0; j < kQuadL; ++j) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float cur_v = s[r][j];
        unsigned cur_g = g;
#pragma unroll
        for (int k = 0; k < kActive; ++k) {
          const bool less = cur_v < vals[r][j][k];
          const float disp_v = fmaxf(cur_v, vals[r][j][k]);
          const unsigned old_g = gidx_in(before, r, j, k);
          vals[r][j][k] = fminf(cur_v, vals[r][j][k]);
          if (less) set_gidx(r, j, k, cur_g);
          cur_v = disp_v;
          cur_g = less ? old_g : cur_g;
        }
        bnd[r][j] = fminf(bnd[r][j], cur_v);
      }
    }
  }

  // Group g's scores s[r][j] of this pass's rows (rows pass*kRows + r of
  // the quad, lanes lane_col + 32*j) into the network with `surv` slots:
  // a build of one count runs its own; one of several branches once a
  // group (surv is uniform) to the network compiled for the count, so no
  // step past surv is issued.
  __device__ __forceinline__ void group_rows(const float (&s)[kRows][kQuadL],
                                             int g, int surv) {
    if constexpr (kExact) {
      insert_rows<kSlots>(s, g);
    } else {
      switch (surv) {
        case 3: insert_rows<3>(s, g); break;
        case 4: insert_rows<4>(s, g); break;
        case 5: insert_rows<5>(s, g); break;
        case 6: insert_rows<6>(s, g); break;
        case 7: insert_rows<7>(s, g); break;
        default: insert_rows<kMaxSurvivors>(s, g); break;
      }
    }
  }

  // This pass's rows of tile ti's block: survivors to cd / ci at column
  // ti*surv*128 + k*128 + lane (INT32_MAX where the value is not finite),
  // the bound to bounds at ti*128 + lane.
  __device__ __forceinline__ void end_pass(int ti, const Out& o,
                                           const Place& p) {
    const int surv = o.geo.surv;
    const size_t out_w = static_cast<size_t>(o.n_tiles) * o.geo.out_w;
    const size_t bound_w = static_cast<size_t>(o.n_tiles) * kBinW;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qrow = p.q0 + p.quad * kQuadQ + pass * kRows + r;
      if (qrow >= o.n_q) continue;
#pragma unroll
      for (int j = 0; j < kQuadL; ++j) {
        const int lane = p.lane_col + 32 * j;
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          if (kExact || k < surv) {
            const size_t at = qrow * out_w +
                              static_cast<size_t>(ti) * o.geo.out_w +
                              k * kBinW + lane;
            const float v = vals[r][j][k];
            o.cd[at] = v;
            o.ci[at] = isfinite(v) ? ti * o.tile_n +
                                         static_cast<int>(
                                             gidx_in(idx, r, j, k)) *
                                             kBinW +
                                         lane
                                   : INT32_MAX;
          }
        }
        o.bounds[qrow * bound_w + static_cast<size_t>(ti) * kBinW + lane] =
            bnd[r][j];
      }
    }
  }

  // A skipped tile (fused): the thread's whole block, every row, as +inf,
  // INT32_MAX, +inf over what the passes stored.
  __device__ __forceinline__ void end_tile(int ti, const Out& o,
                                           const Place& p, bool pad) {
    if (!pad) return;
    const float inf = __int_as_float(0x7f800000);
    const size_t out_w = static_cast<size_t>(o.n_tiles) * o.geo.out_w;
    const size_t bound_w = static_cast<size_t>(o.n_tiles) * kBinW;
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i) {
      const int qrow = p.q0 + p.quad * kQuadQ + i;
      if (qrow >= o.n_q) continue;
#pragma unroll
      for (int j = 0; j < kQuadL; ++j) {
        const int lane = p.lane_col + 32 * j;
        for (int k = 0; k < o.geo.surv; ++k) {
          const size_t at = qrow * out_w +
                            static_cast<size_t>(ti) * o.geo.out_w +
                            k * kBinW + lane;
          o.cd[at] = inf;
          o.ci[at] = INT32_MAX;
        }
        o.bounds[qrow * bound_w + static_cast<size_t>(ti) * kBinW + lane] =
            inf;
      }
    }
  }
};

// Lane binning (K8).  kDepth >= surv + 1: the length of each lane's list.
template <int kDepth>
struct Emitter {
  static constexpr int kPasses = 1;
  float* tile;          // group(): the score tile it writes and reads
  float lv[kDepth];     // this lane's list: values, ascending
  int lr[kDepth];       // ... and their tile rows
  float wv[kLaneVec];   // entry (lane % 8)'s values of the bins in flight
  int wc[kLaneVec];     // ... and their candidate indices
  int bin;              // the tile's bin being gathered
  int bin_group;        // its groups seen so far

  __device__ explicit Emitter(float* score_tile) : tile(score_tile) {}

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      lv[d] = __int_as_float(0x7f800000);
      lr[d] = INT32_MAX;
    }
  }

  __device__ __forceinline__ void begin_pass(int) {
    reset();
    bin = bin_group = 0;
  }

  __device__ __forceinline__ void end_pass(int, const Out&, const Place&) {}

  // (v, row) into the sorted list; strict `<`, so the earlier row stays
  // ahead of an equal value, and +inf and NaN never enter (the list starts
  // at +inf).  Each slot compares with v at once (less[d] implies
  // less[d + 1]) and takes its own entry, its predecessor's or v.
  __device__ __forceinline__ void insert(float v, int row) {
    bool less[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) less[d] = v < lv[d];
#pragma unroll
    for (int d = kDepth - 1; d > 0; --d) {
      lv[d] = less[d - 1] ? lv[d - 1] : less[d] ? v : lv[d];
      lr[d] = less[d - 1] ? lr[d - 1] : less[d] ? row : lr[d];
    }
    lv[0] = less[0] ? v : lv[0];
    lr[0] = less[0] ? row : lr[0];
  }

  // Group g of tile ti from a score tile S (q * kScoreStride + r): lane l
  // of warp w takes query row 4w + l / 8 and rows lane_row(l % 8, k) of
  // the group, each score score(r, S[...]), into its list; at the bin's
  // last group, the merge and the writes.
  template <class ScoreOf>
  __device__ __forceinline__ void group_tile(const float* S, ScoreOf score,
                                             int g, int ti, const Out& o,
                                             const Place& p) {
    const int q = p.quad * kQuadQ + p.lane_col / 8;
    const int slot = p.lane_col % 8;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int r = lane_row(slot, k);
      insert(score(r, S[q * kScoreStride + r]), g * kBinW + r);
    }
    if (++bin_group == o.geo.bin_groups) {
      merge();
      write(bin++, ti, o, p);
      reset();
      bin_group = 0;
    }
  }

  // The emitters' common form (K7's walk): group g's scores s in the
  // threads' layout (queries quad*4 + i, rows lane_col + 32*j) through
  // ``tile`` into group_tile.  Every thread of the CTA calls it.
  __device__ __forceinline__ void group(const Acc& s, int g, int ti,
                                        const Out& o, const Place& p) {
    __syncthreads();   // the tile's readers of the previous group are done
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
      for (int j = 0; j < kQuadL; ++j)
        tile[(p.quad * kQuadQ + i) * kScoreStride + p.lane_col + 32 * j] =
            s[i][j];
    __syncthreads();
    group_tile(tile, [](int, float v) { return v; }, g, ti, o, p);
  }

  // The 8 lanes of a query row (lane / 8 alike) end with the kDepth
  // smallest pairs of all their lists, sorted.
  __device__ __forceinline__ void merge() {
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) {
      float bv[kDepth];
      int br[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        bv[d] = __shfl_xor_sync(0xffffffffu, lv[d], m);
        br[d] = __shfl_xor_sync(0xffffffffu, lr[d], m);
      }
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const bool theirs =
            lane_before(bv[kDepth - 1 - d], br[kDepth - 1 - d], lv[d], lr[d]);
        lv[d] = theirs ? bv[kDepth - 1 - d] : lv[d];
        lr[d] = theirs ? br[kDepth - 1 - d] : lr[d];
      }
      // the list is bitonic (rising, then falling): two exchanges sort 3,
      // odd-even transposition any length
      if constexpr (kDepth == 3) {
        exchange(0, 2);
        exchange(1, 2);
      } else {
#pragma unroll
        for (int ph = 0; ph < kDepth; ++ph)
#pragma unroll
          for (int d = ph % 2; d + 1 < kDepth; d += 2) exchange(d, d + 1);
      }
    }
  }

  // Orders list entries d < e.
  __device__ __forceinline__ void exchange(int d, int e) {
    const bool swap = lane_before(lv[e], lr[e], lv[d], lr[d]);
    const float v = lv[d];
    const int r = lr[d];
    lv[d] = swap ? lv[e] : v;
    lr[d] = swap ? lr[e] : r;
    lv[e] = swap ? v : lv[e];
    lr[e] = swap ? r : lr[e];
  }

  // Bin b's outputs: of the 8 lanes of a query row, lane e writes entry e
  // of the merged list -- survivor e for e < surv, the bound for e ==
  // surv -- gathered over kLaneVec consecutive bins into one 32-byte
  // sector per array where the tile's bins come in whole sectors (n_bins a
  // multiple of kLaneVec), else bin by bin; entry 8 (surv = 8's bound) by
  // lane 0, bin by bin.
  __device__ __forceinline__ void write(int b, int ti, const Out& o,
                                        const Place& p) {
    const Geom& geo = o.geo;
    const int qrow = p.q0 + p.quad * kQuadQ + p.lane_col / 8;
    const int e = p.lane_col % 8;
    if (qrow >= o.n_q || e > geo.surv) return;
    const size_t cd_w = static_cast<size_t>(o.n_tiles) * geo.out_w;
    const size_t b_w = static_cast<size_t>(o.n_tiles) * geo.bound_w;
    // this lane's entry: lv[e] (an unrolled select, no local memory)
    float v = lv[0];
    int r = lr[0];
#pragma unroll
    for (int d = 1; d < kDepth && d < 8; ++d) {
      v = e == d ? lv[d] : v;
      r = e == d ? lr[d] : r;
    }
    const bool bound = e == geo.surv;
    // bin 0 of this lane's entry in the tile's block (cd and ci share a
    // layout)
    const size_t at = bound ? qrow * b_w + static_cast<size_t>(ti) * geo.bound_w
                            : qrow * cd_w +
                                  static_cast<size_t>(ti) * geo.out_w +
                                  e * geo.n_bins;
    float* dst = (bound ? o.bounds : o.cd) + at;
    int* dci = o.ci + at;
    const int c = isfinite(v) ? ti * o.tile_n + r : INT32_MAX;
    if (geo.n_bins % kLaneVec == 0) {
      const int u = b % kLaneVec;
#pragma unroll
      for (int x = 0; x < kLaneVec; ++x) {
        wv[x] = x == u ? v : wv[x];
        wc[x] = x == u ? c : wc[x];
      }
      if (u == kLaneVec - 1) {
        float4* dv = reinterpret_cast<float4*>(dst + b - u);
        dv[0] = make_float4(wv[0], wv[1], wv[2], wv[3]);
        dv[1] = make_float4(wv[4], wv[5], wv[6], wv[7]);
        if (!bound) {
          int4* dc = reinterpret_cast<int4*>(dci + b - u);
          dc[0] = make_int4(wc[0], wc[1], wc[2], wc[3]);
          dc[1] = make_int4(wc[4], wc[5], wc[6], wc[7]);
        }
      }
    } else {
      dst[b] = v;
      if (!bound) dci[b] = c;
    }
    if constexpr (kDepth > 8) {
      if (e == 0 && geo.surv == 8)
        o.bounds[qrow * b_w + static_cast<size_t>(ti) * geo.bound_w + b] =
            lv[8];
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

// The resources of one built kernel as a launch would take them: after
// letting it have its dynamic shared memory, its registers a thread, its
// static shared, local (spill and stack) and dynamic shared bytes, and the
// CTAs of kThreads one SM holds (out[0 .. 4]).  A kernel whose shared
// memory the device refuses fails with the CUDA error here, as its launch
// would.
template <class Kernel>
__host__ cudaError_t kernel_attrs(Kernel* fn, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(smem);
  out[4] = ctas;
  return cudaSuccess;
}

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

// One cell's part of the early-out at a tile's end: the row's tile minimum
// takes the lane minimum, thr the cell's deepest carry value before this
// tile, and the carry the lane minimum (sorted insertion).
__device__ __forceinline__ void carry_cell(float (&carry)[kMaxCarry],
                                           int depth, float lane_min,
                                           float& tmin, float& thr) {
  tmin = fminf(tmin, lane_min);
  thr = fmaxf(thr, carry[depth - 1]);
  float cur = lane_min;
#pragma unroll 1
  for (int d = 0; d < depth; ++d) {
    const float c = carry[d];
    carry[d] = fminf(c, cur);
    cur = fmaxf(c, cur);
  }
}

// The block's decision from each row's tile minimum and thr: true when
// every real query row of the CTA's block has its tile minimum above thr.
// Every thread of the CTA calls it (a barrier).
__device__ __forceinline__ bool block_skip(float (&tmin)[kQuadQ],
                                           float (&thr)[kQuadQ],
                                           const Place& p, int n_q,
                                           int* warp_ok) {
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
    for (int j = 0; j < kQuadL; ++j)
      carry_cell(carry[i][j], depth, em.vals[i][j][0], tmin[i], thr[i]);
  }
  return block_skip(tmin, thr, p, n_q, warp_ok);
}

// The deep grouped build's part at a pass's end: its rows' statistics and
// carry, from each row's lane minima (survivor 0 of each bin).
template <int kDepth>
__device__ __forceinline__ void fused_pass(
    DeepEmitter<kDepth>& em, float (&carry)[kQuadQ][kQuadL][kMaxCarry],
    int depth) {
  if (depth == 0) return;
  constexpr int kRows = DeepEmitter<kDepth>::kRows;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = em.pass * kRows + r;   // of the quad
    float tmin = __int_as_float(0x7f800000), thr = -tmin;
#pragma unroll
    for (int j = 0; j < kQuadL; ++j)
      carry_cell(carry[row][j], depth, em.vals[r][j][0], tmin, thr);
#pragma unroll
    for (int i = 0; i < kQuadQ; ++i) {
      em.tmin[i] = i == row ? tmin : em.tmin[i];
      em.thr[i] = i == row ? thr : em.thr[i];
    }
  }
}

// ... and its decision at the tile's end, from every pass's rows.
template <int kDepth>
__device__ __forceinline__ bool fused_skip(
    DeepEmitter<kDepth>& em, float (&)[kQuadQ][kQuadL][kMaxCarry],
    int depth, const Place& p, int n_q, int* warp_ok) {
  if (depth == 0) return false;
  return block_skip(em.tmin, em.thr, p, n_q, warp_ok);
}

// The emitter of a build: the deep builds' (kDepth < 0), else Emitter.
template <int kDepth>
using EmitterOf = std::conditional_t<(kDepth < 0), DeepEmitter<kDepth>,
                                     Emitter<kDepth>>;

}  // namespace binned
