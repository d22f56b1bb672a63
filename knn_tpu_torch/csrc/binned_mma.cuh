// The tensor-core arms on Hopper: one mainloop that every entry of bf16x3,
// bf16x3f and highest runs -- the tiled kernels K1 / K4 / K2 in either grid
// (binned_coarse.cu), the streaming and fused kernels K10 / K11 and K4's and
// K2's (binned_stream.cu), each in grouped or (K8) lane binning.  One walk,
// one MMA shape and one k-order per arm, so every entry of an arm gives the
// same bits, and a lane build reads the very score tile its grouped build
// reads.  The arm is the walk's template parameter: bf16x3 and bf16x3f run
// mma.sync m16n8k16 (bf16 in, f32 accumulate) and set only how the products
// are grouped into accumulators; highest runs mma.sync m16n8k8 in f64 (the
// FP64 tensor cores, DMMA).
//
// Replaces the CUDA-core arithmetic of K1 / K10 / K11, K4 (f32 FMAs of the
// upcast parts, dim by dim) and K2 (f64 FMAs of the f32 values, dim by
// dim).  The TPU kernels they stand for are knn_tpu/ops/pallas_knn.py::
// _kernel / _stream_kernel: bf16x3 (:384, :613) qt = qh.th + qh.tl +
// ql.th, bf16x3f (:407-414, :704-710) qt = one dot over the 3x contraction
// [qh|qh|ql].[th|tl|th], highest (:453-459, :711-716) qt = the f32 dot at
// HIGHEST precision; s = tnorm - 2 qt.
//
// Design.  A CTA of kThreads = 256 threads (8 warps) owns kBlockQ = 32
// query rows and walks a run of (db tile, 128-row group, 128-dim chunk)
// steps: one step for a tiled entry's one tile, a segment of tiles for the
// streaming and fused entries.
//   - Operands: each step's db chunk rows -- th and tl [128][128] bf16, or
//     highest's f32 rows t [128][128], the same bytes -- are copied with
//     cp.async into one of two shared stages, rows padded to kMmaRow = 136
//     elements (bf16: the 8 rows an ldmatrix phase reads fall in 8
//     different 16-byte bank groups; f32: a warp's 8-byte fragment loads
//     meet 32 different banks), while the previous step computes.  The
//     query block's operand is made in-kernel: bf16x3 / bf16x3f split it
//     into qh, ql [32][136] bf16 with round-to-nearest-even (JAX's astype,
//     = coarse_knn.split_bf16), highest converts it to f64 [32][136] (exact);
//     once per CTA at Dp = 128, per step (its f32 chunk staged beside the
//     db rows) for Dp > 128.
//   - Products: warp w takes db rows w*16 .. w*16+15 of the group as the
//     MMA's M and the 32 queries as N (4 n-tiles of 8).
//     bf16x3 / bf16x3f: K = 16 dims a step, per k-step 2 ldmatrix.x4 of th
//     / tl, 4 of qh / ql, and per n-tile three MMAs in the order th.qh,
//     tl.qh, th.ql.  bf16x3 sums them into two accumulators, hi = qh.th and
//     lo = qh.tl + ql.th (about 2^-8 of hi: its rounding is 2^-8 as large),
//     added once in f32 (round to nearest) at the chunk's end; bf16x3f sums
//     all three into one accumulator, 24 k-steps a chunk (the TPU's one
//     dot).
//     highest: K = 8 dims a step, 16 k-steps a chunk in dim order (step s
//     takes dims 8s .. 8s+7: fragment slot t holds dim 8s + 2t, slot t + 4
//     dim 8s + 2t + 1, so each thread reads its two db values and its two
//     query values of a step with one 8- and one 16-byte load); the db
//     values are converted to f64 as they are loaded (exact), and the
//     chunk's products summed in one f64 accumulator per cell, rounded
//     once to f32 (__double2float_rn) at the chunk's end.
//     The chunk's f32 sum goes to the score tile S [32][132] f32 in shared
//     memory: written at chunk 0, added (round to nearest) at chunks 1 ..
//     nd-1 -- the per-chunk sums of the fault-12 repair, acc = c_0 + c_1 +
//     ... in chunk order.
//   - Emission: after the group's last chunk, S is read in the emitters'
//     thread layout (Place: queries quad*4 + i, lanes lane_col + 32 j) and
//     handed to Emitter<kRounds>::group (grouped network with strict `<`,
//     or the lane merge); K11's carry and skip at the tile's end are
//     fused_skip's (binned_select.cuh).
//
// Numerics, bf16 tensor cores.  The model of one k-step (stated, and probed
// on the card by mma_probe_bf16 / tests): the 16 products of bf16 values
// are exact; they and the accumulator are summed in blocks of at least 8
// products (the accumulator entering the first), each block's addends
// aligned to its largest and truncated to 24 bits, its sum normalised with
// truncation.  A block of n products errs by at most (2 (n + 1) + 2) u
// times the sum of its addends' magnitudes, so one step, two blocks of 8 at
// worst, errs by at most kappa u (|acc| + sum |p|), kappa = 40
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
// bound.  So 3xTF32 (a hi / lo split of f32 values on the tf32 tensor
// cores) cannot serve highest: 16 such steps over one chunk's hi.hi
// products already err by 320 u P_c, five times highest's whole 64 u
// budget in s.
//
// Numerics, FP64 tensor cores (highest).  The model of one m16n8k8 step
// (stated, and probed on the card by dmma_probe_f64 / coarse_knn.
// dmma_rounding_probe): the products of the f32 values are exact in f64,
// and every f64 add of the step rounds to nearest, in any order, so a step
// of k = 8 products errs by at most k 2^-53 (|c| + sum |p|).  A chunk is
// 16 steps into one accumulator: <= 128 * 2^-53 P_c, far under the u P_c
// of its rounding to f32, so binned_select.cuh's highest bound, nd u P (1 +
// 2^-20) for qt, and coarse_knn.accumulation_coefficient("highest") stand
// as they are.
//
// What bounds it on this card.  bf16x3 / bf16x3f: the db bytes.  A
// 32-query block reads each db row's th and tl (512 B at Dp = 128) for 3 x
// 2 x 32 x 128 = 24,576 FLOPs: 48 FLOP per byte, far under the tensor
// cores' ridge (~295 from HBM).  Each pass over the db moves ~0.5 GB, 128
// query blocks ~66 GB through L2: at 4,096 queries x 1M rows either arm
// takes ~21-23 ms (H100 SXM, 700 W), ~3 TB/s of L2 reads, in either grid
// order, against a 3.18 ms bound of operations.  highest reads the same
// 512 B a row (its f32 values) for one f64 product, 2 x 32 x 128 = 8,192
// FLOPs: 1.05e15 FLOPs at 67 TFLOP/s = 15.7 ms of operations, and it takes
// ~28 ms (the same L2 reads, the f64 conversion of every db value a warp
// loads, and grouped builds at the register limit).  One CTA per SM (up to
// 255 registers a thread, the grouped emitter's 80 among them, and 170-219
// KB of shared memory), so the emitter's work and the barriers are not
// hidden behind another CTA's products.  Larger query blocks (the emitter
// state is what the registers cannot hold twice), cluster multicast of the
// db rows, or half the warps emitting while the other half multiply are
// the next steps.

#pragma once

#include "binned_select.cuh"

namespace binned {

// The arms that run on the tensor cores: bf16x3 (K1, K10, K11), bf16x3f
// (K4) on the bf16 ones, highest (K2) on the FP64 ones.
template <Arm kArm>
constexpr bool kUsesMma =
    kArm == Arm::kBf16x3 || kArm == Arm::kBf16x3f || kArm == Arm::kHighest;
template <Arm kArm>
constexpr bool kUsesDmma = kArm == Arm::kHighest;

constexpr int kMmaK = 16;                  // dims per bf16 MMA k-step
constexpr int kDmmaK = 8;                  // dims per f64 MMA k-step
constexpr int kMmaRow = kDimChunk + 8;     // elements per staged row
constexpr int kScoreStride = kBinW + 4;    // f32 per query row of S
// one stage: the db chunk rows -- th and tl [128][kMmaRow] bf16, or
// highest's t [128][kMmaRow] f32, the same bytes -- then (Dp > 128) the
// query block's f32 chunk [32][128]
constexpr size_t kMmaDbBytes = 2 * kBinW * kMmaRow * sizeof(__nv_bfloat16);
static_assert(kMmaDbBytes == kBinW * kMmaRow * sizeof(float),
              "highest's f32 rows fill a bf16x3 stage");
constexpr size_t kMmaQRawBytes = kBlockQ * kDimChunk * sizeof(float);
template <bool kMulti>
constexpr size_t kMmaStageBytes = kMmaDbBytes + (kMulti ? kMmaQRawBytes : 0);
// the query block's operand: qh, ql [32][kMmaRow] bf16, or highest's q
// [32][kMmaRow] f64
template <Arm kArm>
constexpr size_t kMmaQBytes =
    kUsesDmma<kArm> ? kBlockQ * kMmaRow * sizeof(double)
                    : 2 * kBlockQ * kMmaRow * sizeof(__nv_bfloat16);
constexpr size_t kMmaScoreBytes = kBlockQ * kScoreStride * sizeof(float);
// dynamic shared memory of a CTA, one CTA per SM: 173,568 B (bf16x3,
// bf16x3f at Dp = 128), 206,336 B (above), 190,976 B (highest at Dp = 128),
// 223,744 B (above)
template <Arm kArm, bool kMulti>
constexpr size_t kMmaSmemBytes =
    2 * kMmaStageBytes<kMulti> + kMmaQBytes<kArm> + kMmaScoreBytes;
static_assert(kMmaSmemBytes<Arm::kHighest, true> <= 227 * 1024,
              "highest CTA too large");

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

// d += a . b on the FP64 tensor cores (m16n8k8): with g = lane / 4, t =
// lane % 4, a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4] of the 16 x 8
// row fragment, (b0, b1) = B[t][g], B[t+4][g] of the 8 x 8 column fragment,
// d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1] of the 16 x 8 f64
// accumulator.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// Starts the copies of one step: dims c*128 .. c*128+127 of db rows row0 ..
// row0+127 (th and tl bf16, or highest's f32 t with db1 unused), and
// (kWithQ) of the query rows q0 .. q0+31 as f32 (rows past n_q
// zero-filled).
template <Arm kArm, bool kWithQ>
__device__ __forceinline__ void mma_start_stage(
    unsigned char* stage, const void* __restrict__ db0,
    const void* __restrict__ db1, const float* __restrict__ q, size_t row0,
    int c, int dp, int q0, int n_q, int tid) {
  constexpr int kSegs = kDimChunk / 8;   // 16-byte segments per bf16 row
  if constexpr (kUsesDmma<kArm>) {
    float* st = reinterpret_cast<float*>(stage);
    const float* t = static_cast<const float*>(db0);
#pragma unroll
    for (int p = 0; p < 2 * kBinW * kSegs / kThreads; ++p) {
      const int idx = tid + p * kThreads;
      const int r = idx / (2 * kSegs);
      const int seg = idx % (2 * kSegs);
      cp_async16(st + r * kMmaRow + seg * 4,
                 t + (row0 + r) * static_cast<size_t>(dp) + c * kDimChunk +
                     seg * 4,
                 16);
    }
  } else {
    __nv_bfloat16* sth = reinterpret_cast<__nv_bfloat16*>(stage);
    __nv_bfloat16* stl = sth + kBinW * kMmaRow;
    const __nv_bfloat16* th = static_cast<const __nv_bfloat16*>(db0);
    const __nv_bfloat16* tl = static_cast<const __nv_bfloat16*>(db1);
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

// The query block's operand of one chunk, from f32 rows at src (row stride
// ``stride`` floats; rows at or past ``live`` read as zeros), into qs: the
// bf16 parts hi = bf16_rn(x) and lo = bf16_rn(x - hi) (the subtraction is
// exact) at qs and qs + 32 rows, or (highest) x as f64 (exact).
template <Arm kArm>
__device__ __forceinline__ void mma_query(const float* src, size_t stride,
                                          int live, unsigned char* qs,
                                          int tid) {
  constexpr int kQSegs = kDimChunk / 4;
#pragma unroll
  for (int p = 0; p < kBlockQ * kQSegs / kThreads; ++p) {
    const int idx = tid + p * kThreads;
    const int r = idx / kQSegs;
    const int seg = idx % kQSegs;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < live) v = *reinterpret_cast<const float4*>(src + r * stride + seg * 4);
    const int at = r * kMmaRow + seg * 4;
    if constexpr (kUsesDmma<kArm>) {
      double2* qd = reinterpret_cast<double2*>(reinterpret_cast<double*>(qs) + at);
      qd[0] = make_double2(v.x, v.y);
      qd[1] = make_double2(v.z, v.w);
    } else {
      __nv_bfloat16* qh = reinterpret_cast<__nv_bfloat16*>(qs);
      __nv_bfloat16* ql = qh + kBlockQ * kMmaRow;
      const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat16 h = __float2bfloat16_rn(xs[e]);
        qh[at + e] = h;
        ql[at + e] = __float2bfloat16_rn(__fsub_rn(xs[e], __bfloat162float(h)));
      }
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

// A chunk's f32 sum c of cell (query qr, db row ``row`` of the group) into
// the score tile S[query][row]: written at the group's first chunk, added
// after it.  Each thread writes and re-reads only its own fragment's cells.
__device__ __forceinline__ void store_score(float* S, int qr, int row,
                                            float c, bool first) {
  float& s = S[qr * kScoreStride + row];
  s = first ? c : __fadd_rn(s, c);
}

// The chunk's sum (bf16x3: hi + lo, one f32 add; bf16x3f: hi) into S.
template <bool kOne>
__device__ __forceinline__ void mma_store_chunk(const MmaAcc& acc, float* S,
                                                int warp, int lane,
                                                bool first) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store_score(S, nt * 8 + 2 * t + (e & 1), warp * 16 + g + (e >> 1) * 8,
                  kOne ? acc.hi[nt][e]
                       : __fadd_rn(acc.hi[nt][e], acc.lo[nt][e]),
                  first);
}

// highest: one staged chunk (db rows st [128][kMmaRow] f32, the query qd
// [32][kMmaRow] f64) on the FP64 tensor cores, 16 m16n8k8 steps in dim
// order into one f64 accumulator per cell, each rounded once to f32 into
// S.  Step s: fragment slot t holds dim 8s + 2t, slot t + 4 dim 8s + 2t + 1
// (one float2 per db row, one double2 per query).
__device__ __forceinline__ void dmma_chunk(const float* st, const double* qd,
                                           int warp, int lane, float* S,
                                           bool first) {
  const int g = lane >> 2, t = lane & 3;
  double acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0;
  const float* a_lo = st + (warp * 16 + g) * kMmaRow + 2 * t;
  const float* a_hi = a_lo + 8 * kMmaRow;
  const double* b = qd + g * kMmaRow + 2 * t;
#pragma unroll
  for (int s = 0; s < kDimChunk / kDmmaK; ++s) {
    const float2 lo = *reinterpret_cast<const float2*>(a_lo + kDmmaK * s);
    const float2 hi = *reinterpret_cast<const float2*>(a_hi + kDmmaK * s);
    const double a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const double2 bv = *reinterpret_cast<const double2*>(
          b + nt * 8 * kMmaRow + kDmmaK * s);
      mma_f64(acc[nt], a, bv.x, bv.y);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store_score(S, nt * 8 + 2 * t + (e & 1), warp * 16 + g + (e >> 1) * 8,
                  __double2float_rn(acc[nt][e]), first);
}

// Every tensor-core entry's walk (kArm bf16x3, bf16x3f or highest): db
// tiles [t_begin, t_end) for the query block at q0, each tile's groups,
// each group's chunks, through the two-stage ring; the group's scores to
// the emitter; at each tile's end K11's skip (kFused, depth > 0) and the
// tile's block.  q [n_q, dp] f32; db0, db1 the th, tl [n_tiles*tile_n, dp]
// bf16 parts, or highest's t [n_tiles*tile_n, dp] f32 and NULL; tnorm row 0
// of the [8, Np] norm rows.
template <Arm kArm, bool kMulti, int kRounds, bool kFused>
__device__ __forceinline__ void mma_walk(
    const float* __restrict__ q, const void* __restrict__ db0,
    const void* __restrict__ db1, const float* __restrict__ tnorm,
    const Out& out, int dp, int q0, int t_begin, int t_end, int depth,
    unsigned char* smem, int* warp_ok) {
  static_assert(!(kFused && kRounds), "the fused early-out is grouped only");
  static_assert(kUsesMma<kArm>, "the tensor-core walk serves bf16x3, "
                                "bf16x3f and highest");
  constexpr bool kOne = kArm == Arm::kBf16x3f;
  constexpr size_t kStage = kMmaStageBytes<kMulti>;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const Place place{q0, warp, lane};
  const int n_q = out.n_q;
  const int tile_n = out.tile_n;
  const int n_groups = tile_n / kBinW;
  const int nd = dp / kDimChunk;
  unsigned char* qs = smem + 2 * kStage;
  float* S = reinterpret_cast<float*>(qs + kMmaQBytes<kArm>);

  // Dp = 128: the query block's operand once (visible after the first
  // step's barrier)
  if constexpr (!kMulti)
    mma_query<kArm>(q + static_cast<size_t>(q0) * dp, dp, n_q - q0, qs, tid);

  // the next step to stage: (tile nt, group ng, chunk nc)
  int nt = t_begin, ng = 0, nc = 0;
  auto stage_next = [&](unsigned char* st) {
    const size_t row0 =
        static_cast<size_t>(nt) * tile_n + static_cast<size_t>(ng) * kBinW;
    mma_start_stage<kArm, kMulti>(st, db0, db1, q, row0, nc, dp, q0, n_q,
                                  tid);
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
  Emitter<kRounds> em;
  for (int ti = t_begin; ti < t_end; ++ti) {
    em.begin_tile();
    for (int g = 0; g < n_groups; ++g) {
      const size_t row0 =
          static_cast<size_t>(ti) * tile_n + static_cast<size_t>(g) * kBinW;
      for (int c = 0; c < nd; ++c) {
        // this step's stage has landed (every thread's copies); the other
        // stage, the query operand and S are no longer read
        cp_async_wait_all();
        __syncthreads();
        if (nt < t_end) stage_next(smem + (buf ^ 1) * kStage);
        cp_async_commit();
        const unsigned char* st = smem + buf * kStage;
        if constexpr (kMulti) {
          mma_query<kArm>(reinterpret_cast<const float*>(st + kMmaDbBytes),
                          kDimChunk, kBlockQ, qs, tid);
          __syncthreads();
        }
        if constexpr (kUsesDmma<kArm>) {
          dmma_chunk(reinterpret_cast<const float*>(st),
                     reinterpret_cast<const double*>(qs), warp, lane, S,
                     c == 0);
        } else {
          const __nv_bfloat16* sth =
              reinterpret_cast<const __nv_bfloat16*>(st);
          const __nv_bfloat16* qh = reinterpret_cast<const __nv_bfloat16*>(qs);
          MmaAcc acc;
          mma_chunk<kOne>(sth, sth + kBinW * kMmaRow, qh,
                          qh + kBlockQ * kMmaRow, warp, lane, acc);
          mma_store_chunk<kOne>(acc, S, warp, lane, c == 0);
        }
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

// One f64 k-step on its own, for highest's rounding probe: d = c + a . b^T
// with a [16][8] f64 (row, k), b [8][8] f64 (n, k), c and d [16][8] f64,
// row-major in global memory; one warp, one m16n8k8.
__global__ void dmma_probe_kernel(const double* __restrict__ a,
                                  const double* __restrict__ b,
                                  const double* __restrict__ c,
                                  double* __restrict__ d) {
  const int lane = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  const double ra[4] = {a[g * 8 + t], a[(g + 8) * 8 + t], a[g * 8 + t + 4],
                        a[(g + 8) * 8 + t + 4]};
  const int at[4] = {g * 8 + 2 * t, g * 8 + 2 * t + 1, (g + 8) * 8 + 2 * t,
                     (g + 8) * 8 + 2 * t + 1};
  double f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = c[at[e]];
  mma_f64(f, ra, b[g * 8 + t], b[g * 8 + t + 4]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[at[e]] = f[e];
}

}  // namespace binned
