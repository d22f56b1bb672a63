// The bf16x3 and bf16x3f arms on Hopper's tensor cores: one mainloop that
// every entry of both runs -- the tiled kernels K1 / K4 in either grid
// (binned_coarse.cu), the streaming and fused kernels K10 / K11 and K4's
// (binned_stream.cu), each in grouped or (K8) lane binning.  One walk, one
// MMA shape (mma.sync m16n8k16, bf16 in, f32 accumulate) and one k-order
// per arm, so every entry of an arm gives the same bits, and a lane build
// reads the very score tile its grouped build reads.  The arm is the
// walk's template parameter: it sets only how the products are grouped
// into accumulators.
//
// Replaces the CUDA-core arithmetic of K1 / K10 / K11 and K4 (f32 FMAs of
// the upcast parts, dim by dim; K4 walked each chunk once per product).
// The TPU kernels they stand for are knn_tpu/ops/pallas_knn.py::_kernel /
// _stream_kernel: bf16x3 (:384, :613) qt = qh.th + qh.tl + ql.th, and
// bf16x3f (:407-414, :704-710) qt = one dot over the 3x contraction
// [qh|qh|ql].[th|tl|th]; s = tnorm - 2 qt.
//
// Design.  A CTA of kThreads = 256 threads (8 warps) owns kBlockQ = 32
// query rows and walks a run of (db tile, 128-row group, 128-dim chunk)
// steps: one step for a tiled entry's one tile, a segment of tiles for the
// streaming and fused entries.
//   - Operands: each step's th and tl chunk rows [128][128] bf16 are
//     copied with cp.async into one of two shared stages, rows padded to
//     kMmaRow = 136 bf16 (272 B: the 8 rows an ldmatrix phase reads fall in
//     8 different 16-byte bank groups), while the previous step computes.
//     The query block's parts qh, ql [32][136] bf16 are split in-kernel
//     with round-to-nearest-even (JAX's astype, = coarse_knn.split_bf16):
//     once per CTA at Dp = 128, per step (its f32 chunk staged beside the
//     db rows) for Dp > 128.
//   - Products: warp w takes db rows w*16 .. w*16+15 of the group as the
//     MMA's M and the 32 queries as N (4 n-tiles of 8), K = 16 dims a
//     step: per k-step 2 ldmatrix.x4 of th / tl, 4 of qh / ql, and per
//     n-tile three MMAs in the order th.qh, tl.qh, th.ql.  bf16x3 sums
//     them into two accumulators, hi = qh.th and lo = qh.tl + ql.th (about
//     2^-8 of hi: its rounding is 2^-8 as large), added once in f32 (round
//     to nearest) at the chunk's end; bf16x3f sums all three into one
//     accumulator, 24 k-steps a chunk (the TPU's one dot).  The chunk's sum
//     goes to the score tile S [32][132] f32 in shared memory: written at
//     chunk 0, added (round to nearest) at chunks 1 .. nd-1 -- the
//     per-chunk sums of the fault-12 repair, acc = c_0 + c_1 + ... in chunk
//     order.
//   - Emission: after the group's last chunk, S is read in the emitters'
//     thread layout (Place: queries quad*4 + i, lanes lane_col + 32 j) and
//     handed to Emitter<kSlots>::group, unchanged (grouped network with
//     strict `<`, or the lane lists); K11's carry and skip at the tile's
//     end are fused_skip's (binned_select.cuh).
//
// Numerics.  The model of one k-step (stated, and probed on the card by
// mma_probe_bf16 / tests): the 16 products of bf16 values are exact; they
// and the accumulator are summed in blocks of at least 8 products (the
// accumulator entering the first), each block's addends aligned to its
// largest and truncated to 24 bits, its sum normalised with truncation.
// A block of n products errs by at most (2 (n + 1) + 2) u times the sum
// of its addends' magnitudes, so one step, two blocks of 8 at worst,
// errs by at most kappa u (|acc| + sum |p|), kappa = 40
// (coarse_knn.MMA_KAPPA).  Within a chunk every step's |acc| + sum |p| is
// at most the chunk's P_c (the sum of the magnitudes of its products, to
// first order), so an accumulator that takes n steps errs by <= n kappa u
// P_c.  The second-order terms (|acc| carries the earlier steps' errors,
// at most 24 kappa u = 2^-14.1 of it) are covered by a factor (1 + 2^-7).
//   - bf16x3: hi and lo take 8 steps each, together 8 kappa u P_c = 320 u
//     P_c over all three products; their add, u P_c; the nd - 1 chunk
//     adds, (nd - 1) u P.  So |err(qt)| <= (320 + nd)(1 + 2^-7) u P.
//   - bf16x3f: the one accumulator takes 24 steps, 24 kappa u P_c = 960 u
//     P_c; no add inside the chunk; the nd - 1 chunk adds.  So |err(qt)|
//     <= (960 + nd - 1)(1 + 2^-7) u P.
// In s = tn - 2 qt, with P <= (||q||^2 + M) / 2, these coefficients times
// u (||q||^2 + M): 0.32 (bf16x3) and 0.945 (bf16x3f) of 2^-14 at Dp = 128
// (coarse_knn.accumulation_coefficient).  The certificate's tolerance adds
// the split's proved error (binned_select.cuh, 0.756 of 2^-14) and the f32
// headroom (64 u, 0.0625 of 2^-14): 1.134 x 2^-14 (bf16x3) and 1.763 x
// 2^-14 (bf16x3f) at Dp = 128 (coarse_knn.bf16_tolerance_scale).  The
// bound holds for any order of the steps; the one that runs, th.qh before
// the two small products in every k-step, is what the tests replay
// (coarse_knn.mma_step_model).  On an H100 the probe (chip_smoke.py's
// kernel phase) finds a step keeping two bits below an accumulator of 1
// and truncating: a 0.75-ulp product is dropped, sixteen 0.47-ulp products
// add 4 of their 7.5 ulps; every case stays within 0.18 of the model's
// bound.
//
// What bounds it on this card: the db bytes.  A 32-query block reads each
// db row's th and tl (512 B at Dp = 128) for 3 x 2 x 32 x 128 = 24,576
// FLOPs: 48 FLOP per byte, far under the tensor cores' ridge (~295 from
// HBM).  Each pass over the db moves ~0.5 GB, 128 query blocks ~66 GB
// through L2: at 4,096 queries x 1M rows either arm takes ~21-23 ms (H100
// SXM, 700 W), ~3 TB/s of L2 reads, in either grid order, against a 3.18
// ms bound of operations.  One CTA per SM (up to 244 registers a thread,
// the emitter's 80 among them, and 170-202 KB of shared memory), so the
// emitter's work and the barriers are not hidden behind another CTA's
// products.  Larger query blocks (the emitter state is what the registers
// cannot hold twice) or cluster multicast of the db rows are the next
// step.

#pragma once

#include "binned_select.cuh"

namespace binned {

// The arms that run on the tensor cores: bf16x3 (K1, K10, K11) and
// bf16x3f (K4).
template <Arm kArm>
constexpr bool kUsesMma = kArm == Arm::kBf16x3 || kArm == Arm::kBf16x3f;

constexpr int kMmaK = 16;                  // dims per MMA k-step
constexpr int kMmaRow = kDimChunk + 8;     // bf16 per staged row (272 B)
constexpr int kScoreStride = kBinW + 4;    // f32 per query row of S
// one stage: th and tl chunk rows [128][kMmaRow] bf16, then (Dp > 128) the
// query block's f32 chunk [32][128]
constexpr size_t kMmaDbBytes = 2 * kBinW * kMmaRow * sizeof(__nv_bfloat16);
constexpr size_t kMmaQRawBytes = kBlockQ * kDimChunk * sizeof(float);
template <bool kMulti>
constexpr size_t kMmaStageBytes = kMmaDbBytes + (kMulti ? kMmaQRawBytes : 0);
constexpr size_t kMmaQBytes = 2 * kBlockQ * kMmaRow * sizeof(__nv_bfloat16);
constexpr size_t kMmaScoreBytes = kBlockQ * kScoreStride * sizeof(float);
// dynamic shared memory of a bf16x3 CTA: 173,568 B (Dp = 128) or 206,336
// B (Dp > 128), one CTA per SM
template <bool kMulti>
constexpr size_t kMmaSmemBytes =
    2 * kMmaStageBytes<kMulti> + kMmaQBytes + kMmaScoreBytes;
static_assert(kMmaSmemBytes<true> <= 227 * 1024, "bf16x3 CTA too large");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src_bytes < 16 zero-fills the rest (query rows past n_q)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// d += a . b on the tensor cores: a the 16 x 16 row fragment, (b0, b1) the
// 16 x 8 column fragment, d the 16 x 8 f32 accumulator fragment.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Starts the copies of one step: dims c*128 .. c*128+127 of db rows row0 ..
// row0+127 of th and tl, and (kWithQ) of the query rows q0 .. q0+31 as f32
// (rows past n_q zero-filled).
template <bool kWithQ>
__device__ __forceinline__ void mma_start_stage(
    unsigned char* stage, const __nv_bfloat16* __restrict__ th,
    const __nv_bfloat16* __restrict__ tl, const float* __restrict__ q,
    size_t row0, int c, int dp, int q0, int n_q, int tid) {
  __nv_bfloat16* sth = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* stl = sth + kBinW * kMmaRow;
  constexpr int kSegs = kDimChunk / 8;   // 16-byte segments per row
#pragma unroll
  for (int p = 0; p < kBinW * kSegs / kThreads; ++p) {
    const int idx = tid + p * kThreads;
    const int r = idx / kSegs;
    const int seg = idx % kSegs;
    const size_t off = (row0 + r) * static_cast<size_t>(dp) +
                       c * kDimChunk + seg * 8;
    cp_async16(sth + r * kMmaRow + seg * 8, th + off, 16);
    cp_async16(stl + r * kMmaRow + seg * 8, tl + off, 16);
  }
  if constexpr (kWithQ) {
    float* sq = reinterpret_cast<float*>(stage + kMmaDbBytes);
    constexpr int kQSegs = kDimChunk / 4;
#pragma unroll
    for (int p = 0; p < kBlockQ * kQSegs / kThreads; ++p) {
      const int idx = tid + p * kThreads;
      const int r = idx / kQSegs;
      const int seg = idx % kQSegs;
      const bool live = q0 + r < n_q;
      const float* src = q + static_cast<size_t>(live ? q0 + r : 0) * dp +
                         c * kDimChunk + seg * 4;
      cp_async16(sq + r * kDimChunk + seg * 4, src, live ? 16 : 0);
    }
  }
}

// The query block's bf16 parts of one chunk, from f32 rows at src (row
// stride ``stride`` floats; rows at or past ``live`` read as zeros): hi =
// bf16_rn(x), lo = bf16_rn(x - hi) (the subtraction is exact).
__device__ __forceinline__ void mma_split_query(const float* src, size_t stride,
                                                int live, __nv_bfloat16* qh,
                                                __nv_bfloat16* ql, int tid) {
  constexpr int kQSegs = kDimChunk / 4;
#pragma unroll
  for (int p = 0; p < kBlockQ * kQSegs / kThreads; ++p) {
    const int idx = tid + p * kThreads;
    const int r = idx / kQSegs;
    const int seg = idx % kQSegs;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < live) v = *reinterpret_cast<const float4*>(src + r * stride + seg * 4);
    const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat16 h = __float2bfloat16_rn(xs[e]);
      qh[r * kMmaRow + seg * 4 + e] = h;
      ql[r * kMmaRow + seg * 4 + e] =
          __float2bfloat16_rn(__fsub_rn(xs[e], __bfloat162float(h)));
    }
  }
}

// The accumulators of a warp's 16 db rows x 32 queries: [n-tile][4].
// bf16x3 keeps two, bf16x3f (kOne) one: ``hi`` alone.
struct MmaAcc {
  float hi[4][4];   // qh . th (bf16x3f: every product)
  float lo[4][4];   // qh . tl + ql . th (bf16x3 only)
};

// One staged chunk's products into ``acc`` (zeroed here): 8 k-steps in
// order, per step and n-tile th.qh, tl.qh, th.ql -- into hi, lo, lo
// (bf16x3), or all three into hi (kOne, bf16x3f: 24 steps a chunk into one
// accumulator, the TPU's one dot over the 3x contraction).
template <bool kOne>
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* sth,
                                          const __nv_bfloat16* stl,
                                          const __nv_bfloat16* qh,
                                          const __nv_bfloat16* ql, int warp,
                                          int lane, MmaAcc& acc) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.hi[nt][e] = acc.lo[nt][e] = 0.0f;
  // ldmatrix addresses: A rows of this warp (matrices: rows 0-7 / 8-15 x
  // dims 0-7 / 8-15), B query rows (matrices: queries 0-7 dims 0-7, 0-7 x
  // 8-15, 8-15 x 0-7, 8-15 x 8-15 of a 16-query pair)
  const int a_off = (warp * 16 + (lane & 15)) * kMmaRow + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * kMmaRow +
                    ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kDimChunk / kMmaK; ++kk) {
    uint32_t ah[4], al[4], bh[2][4], bl[2][4];
    ldsm_x4(ah, sth + a_off + kk * kMmaK);
    ldsm_x4(al, stl + a_off + kk * kMmaK);
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      ldsm_x4(bh[pr], qh + pr * 16 * kMmaRow + b_off + kk * kMmaK);
      ldsm_x4(bl[pr], ql + pr * 16 * kMmaRow + b_off + kk * kMmaK);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int pr = nt / 2, h = 2 * (nt % 2);
      float (&second)[4] = *(kOne ? &acc.hi[nt] : &acc.lo[nt]);
      mma_bf16(acc.hi[nt], ah, bh[pr][h], bh[pr][h + 1]);
      mma_bf16(second, al, bh[pr][h], bh[pr][h + 1]);
      mma_bf16(second, ah, bl[pr][h], bl[pr][h + 1]);
    }
  }
}

// The chunk's sum (bf16x3: hi + lo, one f32 add; bf16x3f: hi) into the
// score tile S[query][row]: written at the group's first chunk, added
// after it.  Each thread writes and re-reads only its own fragment's cells.
template <bool kOne>
__device__ __forceinline__ void mma_store_chunk(const MmaAcc& acc, float* S,
                                                int warp, int lane,
                                                bool first) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qr = nt * 8 + 2 * t + (e & 1);
      const int row = warp * 16 + g + (e >> 1) * 8;
      const float c =
          kOne ? acc.hi[nt][e] : __fadd_rn(acc.hi[nt][e], acc.lo[nt][e]);
      float& s = S[qr * kScoreStride + row];
      s = first ? c : __fadd_rn(s, c);
    }
}

// Every bf16x3 and bf16x3f entry's walk (kArm one of the two): db tiles
// [t_begin, t_end) for the query block at q0, each tile's groups, each
// group's chunks, through the two-stage ring; the group's scores to the
// emitter; at each tile's end K11's skip (kFused, depth > 0) and the
// tile's block.  q [n_q, dp] f32; th, tl [n_tiles*tile_n, dp] bf16; tnorm
// row 0 of the [8, Np] norm rows.
template <Arm kArm, bool kMulti, int kSlots, bool kFused>
__device__ __forceinline__ void bf16x3_walk(
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ th,
    const __nv_bfloat16* __restrict__ tl, const float* __restrict__ tnorm,
    const Out& out, int dp, int q0, int t_begin, int t_end, int depth,
    unsigned char* smem, int* warp_ok) {
  static_assert(!(kFused && kSlots), "the fused early-out is grouped only");
  static_assert(kUsesMma<kArm>, "the tensor-core walk serves bf16x3 / bf16x3f");
  constexpr bool kOne = kArm == Arm::kBf16x3f;
  constexpr size_t kStage = kMmaStageBytes<kMulti>;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const Place place{q0, warp, lane};
  const int n_q = out.n_q;
  const int tile_n = out.tile_n;
  const int n_groups = tile_n / kBinW;
  const int nd = dp / kDimChunk;
  __nv_bfloat16* qh = reinterpret_cast<__nv_bfloat16*>(smem + 2 * kStage);
  __nv_bfloat16* ql = qh + kBlockQ * kMmaRow;
  float* S = reinterpret_cast<float*>(smem + 2 * kStage + kMmaQBytes);

  // Dp = 128: the query block's parts once (visible after the first
  // step's barrier)
  if constexpr (!kMulti)
    mma_split_query(q + static_cast<size_t>(q0) * dp, dp, n_q - q0, qh, ql,
                    tid);

  // the next step to stage: (tile nt, group ng, chunk nc)
  int nt = t_begin, ng = 0, nc = 0;
  auto stage_next = [&](unsigned char* st) {
    const size_t row0 =
        static_cast<size_t>(nt) * tile_n + static_cast<size_t>(ng) * kBinW;
    mma_start_stage<kMulti>(st, th, tl, q, row0, nc, dp, q0, n_q, tid);
    if (++nc == nd) {
      nc = 0;
      if (++ng == n_groups) {
        ng = 0;
        ++nt;
      }
    }
  };
  stage_next(smem);
  cp_async_commit();
  int buf = 0;

  float carry[kQuadQ][kQuadL][kMaxCarry];
  if constexpr (kFused) reset_carry(carry, depth);
  Emitter<kSlots> em;
  for (int ti = t_begin; ti < t_end; ++ti) {
    em.begin_tile();
    for (int g = 0; g < n_groups; ++g) {
      const size_t row0 =
          static_cast<size_t>(ti) * tile_n + static_cast<size_t>(g) * kBinW;
      for (int c = 0; c < nd; ++c) {
        // this step's stage has landed (every thread's copies); the other
        // stage, the query parts and S are no longer read
        cp_async_wait_all();
        __syncthreads();
        if (nt < t_end) stage_next(smem + (buf ^ 1) * kStage);
        cp_async_commit();
        const unsigned char* st = smem + buf * kStage;
        if constexpr (kMulti) {
          mma_split_query(reinterpret_cast<const float*>(st + kMmaDbBytes),
                          kDimChunk, kBlockQ, qh, ql, tid);
          __syncthreads();
        }
        const __nv_bfloat16* sth = reinterpret_cast<const __nv_bfloat16*>(st);
        MmaAcc acc;
        mma_chunk<kOne>(sth, sth + kBinW * kMmaRow, qh, ql, warp, lane, acc);
        mma_store_chunk<kOne>(acc, S, warp, lane, c == 0);
        buf ^= 1;
      }
      __syncthreads();   // S complete
      Acc a;
#pragma unroll
      for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
        for (int j = 0; j < kQuadL; ++j)
          a[i][j] = S[(warp * kQuadQ + i) * kScoreStride + lane + 32 * j];
      em.group(a, tnorm, row0, g, ti, out, place);
    }
    bool skip = false;
    if constexpr (kFused)
      skip = fused_skip(em, carry, depth, place, n_q, warp_ok);
    em.end_tile(ti, out, place, skip);
  }
}

// One k-step on its own, for the rounding probe: d = c + a . b^T with a
// [16][16] bf16 (row, k), b [8][16] bf16 (n, k), c and d [16][8] f32, all
// row-major in global memory; one warp.
__global__ void mma_probe_kernel(const __nv_bfloat16* __restrict__ a,
                                 const __nv_bfloat16* __restrict__ b,
                                 const float* __restrict__ c,
                                 float* __restrict__ d) {
  const int lane = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  auto pair = [](const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  };
  const uint32_t ra[4] = {pair(a + g * 16 + 2 * t),
                          pair(a + (g + 8) * 16 + 2 * t),
                          pair(a + g * 16 + 2 * t + 8),
                          pair(a + (g + 8) * 16 + 2 * t + 8)};
  const uint32_t b0 = pair(b + g * 16 + 2 * t);
  const uint32_t b1 = pair(b + g * 16 + 2 * t + 8);
  const int at[4] = {g * 8 + 2 * t, g * 8 + 2 * t + 1, (g + 8) * 8 + 2 * t,
                     (g + 8) * 8 + 2 * t + 1};
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = c[at[e]];
  mma_bf16(f, ra, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[at[e]] = f[e];
}

}  // namespace binned
