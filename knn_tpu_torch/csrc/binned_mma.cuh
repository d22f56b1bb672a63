// The tensor-core mainloop on Hopper that every coarse entry but pq's runs:
// the tiled kernels K1 / K4 / K2 / K3 / K5 / K6 in either grid
// (binned_coarse.cu), the streaming and fused kernels K10 / K11 and the
// other arms' (binned_stream.cu), each in grouped or (K8) lane binning.
// One walk, one MMA shape and one k-order per arm, so every entry of an arm
// gives the same bits, and a lane build reads the very score tile its
// grouped build reads.  The arm is the walk's template parameter:
//   bf16x3, bf16x3f, default: mma.sync m16n8k16 (bf16 in, f32 accumulate);
//     the arm sets the products and how they are grouped into accumulators
//   highest: mma.sync m16n8k8 in f64 (the FP64 tensor cores, DMMA)
//   int8, int4: mma.sync m16n8k32 (s8 in, s32 accumulate; IMMA)
//
// The TPU kernels it stands for are knn_tpu/ops/pallas_knn.py::
// _kernel / _stream_kernel: bf16x3 (:384, :613) qt = qh.th + qh.tl +
// ql.th, bf16x3f (:407-414, :704-710) qt = one dot over the 3x contraction
// [qh|qh|ql].[th|tl|th], highest (:453-459, :711-716) qt = the f32 dot at
// HIGHEST precision, default (the same lines at Precision.DEFAULT) qt = one
// bf16 pass qh.th, int8 / int4 (:415-442, :686-693, :753-760) qt = (f32(qi
// . ti) * qsc) * ts; s = tnorm - 2 qt.
//
// Design.  A CTA of kThreads = 256 threads (8 warps) owns kBlockQ = 32
// query rows and walks a run of (db tile, 128-row group, 128-dim chunk)
// steps: one step for a tiled entry's one tile, a segment of tiles for the
// streaming and fused entries.
//   - Operands: each step's db chunk rows are copied with cp.async into a
//     ring of kRing shared stages while earlier steps compute: th and tl
//     [128][128] bf16 (bf16x3, bf16x3f), highest's f32 rows t (the same
//     bytes), default's th alone, the int8 rows, or int4's packed rows
//     [128][64] bytes.  Rows are padded -- bf16 and f32 to kMmaRow = 136
//     elements, int8 to kImmaRow = 144 bytes -- so the 8 rows an ldmatrix
//     phase reads fall in 8 different 16-byte bank groups (f32: a warp's
//     8-byte fragment loads meet 32 different banks).  The two-operand
//     arms keep two stages; default's stage is half as large and the int
//     arms' smaller still, so they keep four, the next three steps in
//     flight (on an H100 four and two stages time within 5% of each other
//     in every entry, four ahead for int8, two by 1-2% for int4:
//     probes/ring_depth.py).
//     int4's stage is unpacked through registers (unpack_int4:
//     nibble bias 8, the chunk-paired layout of ops/quantize.pack_nibbles)
//     into one padded int8 buffer, the layout int8 stages in.  The query
//     block's operand: bf16x3 / bf16x3f split it in-kernel into qh, ql
//     [32][136] bf16 with round-to-nearest-even (JAX's astype, =
//     coarse_knn.split_bf16), default keeps qh alone, highest converts it
//     to f64 [32][136] (exact); the int arms copy their int8 rows [32][144]
//     as they are.  Once per CTA at Dp = 128 (the int arms' B fragments
//     then stay in registers for the whole walk); for Dp > 128 per step,
//     the query's chunk staged beside the db rows (f32, or the int8 rows,
//     which the MMAs then read from the stage itself).
//   - Products: warp w takes db rows w*16 .. w*16+15 of the group as the
//     MMA's M and the 32 queries as N (4 n-tiles of 8).
//     bf16: K = 16 dims a step, 8 k-steps a chunk in dim order, per k-step
//     ldmatrix.x4 of the db rows and of the query pairs.  bf16x3: per
//     n-tile three MMAs in the order th.qh, tl.qh, th.ql into two
//     accumulators, hi = qh.th and lo = qh.tl + ql.th (about 2^-8 of hi:
//     its rounding is 2^-8 as large), added once in f32 (round to nearest)
//     at the chunk's end; bf16x3f all three into one accumulator, 24
//     k-steps a chunk (the TPU's one dot); default one MMA th.qh per
//     n-tile into one accumulator, 8 k-steps a chunk.
//     highest: K = 8 dims a step, 16 k-steps a chunk in dim order (step s
//     takes dims 8s .. 8s+7: fragment slot t holds dim 8s + 2t, slot t + 4
//     dim 8s + 2t + 1, so each thread reads its two db values and its two
//     query values of a step with one 8- and one 16-byte load); the db
//     values are converted to f64 as they are loaded (exact), and the
//     chunk's products summed in one f64 accumulator per cell, rounded
//     once to f32 (__double2float_rn) at the chunk's end.
//     int8 / int4: K = 32 dims a step, 4 k-steps a chunk, per k-step one
//     ldmatrix.x4 of the db rows (the 16 x 32-byte A fragment) and two of
//     the query rows (B, two n-tiles each), one m16n8k32 per n-tile into
//     an int32 accumulator that runs across every chunk of Dp (the JAX
//     body's int32 sum, pallas_knn.py:415-428).  The sum is exact (|qi.ti|
//     <= 128^2 Dp fits int32 far past any real dim), so the order of
//     the steps does not matter: the kernel is bitwise its plain version.
//     The f32-family chunk's f32 sum goes to the score tile S [32][132] f32
//     in shared memory: written at chunk 0, added (round to nearest) at
//     chunks 1 .. nd-1 -- the per-chunk sums of the fault-12 repair, acc =
//     c_0 + c_1 + ... in chunk order.  The int arms store the scores
//     themselves at the group's last chunk: each thread rescales its own
//     cells' exact dots once, (f32_rn(dot) * qsc) * ts in the TPU kernel's
//     order (pallas_knn.py:465-476), and forms s = tn - 2 qt, the row norms
//     and scales of its two fragment rows read from that chunk's ring
//     stage (copied there three steps ahead).
//   - Emission: after the group's last chunk (a barrier), the grouped
//     emitter reads S in its thread layout (Place: queries quad*4 + i,
//     lanes lane_col + 32 j) -- the f32 family forming s = tn - 2 qt on
//     the way, tn in registers, loaded from global memory at the start of
//     the group's last chunk -- into its insertion network with strict
//     `<`; the lane emitter (K8) reads it in its own layout
//     (binned_select.cuh's lane_row), the f32 family's norms from a 128-row
//     buffer beside S that warp 0 fills before the barrier.  Loaded where
//     they are used, the norms' L2 latency would stand in every step with
//     nothing to hide it (one CTA per SM).  K11's carry and skip at the
//     tile's end are fused_skip's (binned_select.cuh).
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
//   - default: the one accumulator takes 8 steps of qh.th, 8 kappa u P_c =
//     320 u P_c; no add inside the chunk; the nd - 1 chunk adds.  So
//     |err(qt)| <= (8 kappa + nd - 1)(1 + 2^-7) u P, P = sum |qh_i th_i|,
//     against the exact sum of the same products (the bf16 rounding of q
//     and t is the arm's definition, the TPU's one pass, not its error).
// In s = tn - 2 qt, with P <= (||q||^2 + M) / 2, these coefficients times
// u (||q||^2 + M): 0.32 (bf16x3) and 0.945 (bf16x3f) of 2^-14 at Dp = 128
// (coarse_knn.accumulation_coefficient).  The certificate's tolerance adds
// the split's proved error (binned_select.cuh, 0.756 of 2^-14) and the f32
// headroom (64 u, 0.0625 of 2^-14): 1.134 x 2^-14 (bf16x3) and 1.763 x
// 2^-14 (bf16x3f) at Dp = 128 (coarse_knn.bf16_tolerance_scale).  Default
// has no certificate tolerance (the reference refuses it in the one-pass
// certificate); its bound serves the kernel-vs-plain comparison
// (coarse_knn.kernel_plain_tolerance_scale("default", nd)): the plain
// version sums each chunk's 128 exact products in one f32 matmul, in any
// order (127 adds), then the nd - 1 chunk adds; counted as (128 + nd)(1 +
// 2^-7) u P, two adds more than it makes.  The two sums of the same
// products differ by at most the sum of both bounds, doubled in s; with
// both roundings of s (|s| <= 2 (||q||^2 + M)) the tolerance is (8 kappa +
// nd - 1 + 128 + nd)(1 + 2^-7) + 4 times u (||q||^2 + M): 456.5 u at Dp =
// 128, 468.6 u at Dp = 896.  P here sums the bf16 values' products, so P
// <= (1 + 2^-8)^2 (||q||^2 + M) / 2 (bf16_rn moves a value by at most
// 2^-8 of it); the plain count's two spare adds, 2 u P, cover that factor
// on both bounds (452 (2^-7 + 2^-16) < 2).  A pair of f32 FMA chains (the
// CUDA-core kernel this walk replaced against the same plain version)
// could differ by (256 + 2 nd + 4) u (||q||^2 + M); the 128 u the port
// held default to before had no proof.  Every bound holds for any order
// of the steps; the one that runs, th.qh before the two small products in
// every k-step, is what the tests replay (coarse_knn.mma_step_model).  On
// an H100 the probe (chip_smoke.py's kernel phase) finds a step keeping
// two bits below an accumulator of 1 and truncating: a 0.75-ulp product is
// dropped, sixteen 0.47-ulp products add 4 of their 7.5 ulps; every case
// stays within 0.18 of the model's bound.  So 3xTF32 (a hi / lo split of
// f32 values on the tf32 tensor cores) cannot serve highest: 16 such steps
// over one chunk's hi.hi products already err by 320 u P_c, five times
// highest's whole 64 u budget in s.
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
// What bounds it on this card.  The L2 reads of the db rows: a 32-query
// block reads every db row once, so Q/32 passes over the db go through L2.
// bf16x3 / bf16x3f read th and tl (512 B a row at Dp = 128) for 3 x 2 x 32
// x 128 = 24,576 FLOPs: 48 FLOP per byte, far under the tensor cores'
// ridge (~295 from HBM).  Each pass moves ~0.5 GB, 128 query blocks ~66 GB
// through L2: at 4,096 queries x 1M rows either arm takes ~19-20 ms (H100
// SXM, 700 W), ~3.4 TB/s of L2 reads, in either grid order, against a 3.18
// ms bound of operations.  highest reads the same 512 B a row (its f32
// values) for one f64 product, 2 x 32 x 128 = 8,192 FLOPs: 1.05e15 FLOPs
// at 67 TFLOP/s = 15.7 ms of operations, and it takes ~26-27 ms.  default
// reads th alone (256 B a row, ~33 GB through L2 at that shape) for one
// bf16 product, 1.06 ms of operations, and takes ~11-12 ms (~3 TB/s);
// int8 reads 128 B a row (~17 GB) for Q N Dp int8 MACs, 0.53 ms of
// operations at 1,979 TOP/s, and takes ~7.5 ms, int4 (64 B a row,
// unpacked in shared memory) ~8.5 ms: there the step's fixed costs (two
// barriers, the emitter, the score tile) outweigh the bytes.  One CTA per
// SM (up to 255 registers a thread, the grouped emitter's 80 among them),
// so the emitter's work and the barriers are not hidden behind another
// CTA's products.  Larger query blocks (the emitter state is what the
// registers cannot hold twice), cluster multicast of the db rows, or
// emitting one group while the next multiplies are the next steps.

#pragma once

#include "binned_select.cuh"

namespace binned {

// The arms the walk serves: every one but pq (binned_pq.cuh) -- bf16x3
// (K1, K10, K11), bf16x3f (K4) and default (K3) on the bf16 tensor cores,
// highest (K2) on the FP64 ones, int8 (K5) and int4 (K6) on the s8 ones.
template <Arm kArm>
constexpr bool kUsesMma = kArm != Arm::kPq;
template <Arm kArm>
constexpr bool kUsesDmma = kArm == Arm::kHighest;

constexpr int kMmaK = 16;                  // dims per bf16 MMA k-step
constexpr int kDmmaK = 8;                  // dims per f64 MMA k-step
constexpr int kImmaK = 32;                 // dims per s8 MMA k-step
constexpr int kMmaRow = kDimChunk + 8;     // elements per staged bf16 / f32 row
constexpr int kImmaRow = kDimChunk + 16;   // bytes per staged int8 row

// Stages in the ring: two for the two-operand arms, four for the
// one-operand ones (default, int8, int4), whose stages are half the size
// or less.
template <Arm kArm>
constexpr int kRing = kArm == Arm::kDefault || kIsInt<kArm> ? 4 : 2;

// Bytes of one stage's db chunk rows: th and tl [128][kMmaRow] bf16, or
// highest's t [128][kMmaRow] f32 (the same bytes); default's th alone;
// int8 [128][kImmaRow]; int4's packed rows [128][64].
template <Arm kArm>
constexpr size_t kMmaDbBytes =
    kArm == Arm::kDefault ? kBinW * kMmaRow * sizeof(__nv_bfloat16)
    : kArm == Arm::kInt8  ? kBinW * kImmaRow
    : kArm == Arm::kInt4  ? kBinW * db_row_bytes<Arm::kInt4>(kDimChunk)
                          : 2 * kBinW * kMmaRow * sizeof(__nv_bfloat16);
static_assert(kMmaDbBytes<Arm::kBf16x3> == kBinW * kMmaRow * sizeof(float),
              "highest's f32 rows fill a bf16x3 stage");
// ... then (Dp > 128) the query block's chunk: f32 [32][128], or the int
// arms' int8 rows [32][kImmaRow]
template <Arm kArm>
constexpr size_t kMmaQRawBytes = kIsInt<kArm>
                                     ? kBlockQ * kImmaRow
                                     : kBlockQ * kDimChunk * sizeof(float);
// ... then (the int arms) the group's row norms and row scales [2][128]
// f32, staged with its last chunk
template <Arm kArm>
constexpr size_t kMmaRowsBytes = kIsInt<kArm> ? 2 * kBinW * sizeof(float) : 0;
template <Arm kArm, bool kMulti>
constexpr size_t kMmaStageBytes = kMmaDbBytes<kArm> +
                                  (kMulti ? kMmaQRawBytes<kArm> : 0) +
                                  kMmaRowsBytes<kArm>;
// the query block's operand: qh, ql [32][kMmaRow] bf16; default's qh;
// highest's q [32][kMmaRow] f64; the int arms' int8 rows [32][kImmaRow]
// (read at Dp = 128 only)
template <Arm kArm>
constexpr size_t kMmaQBytes =
    kUsesDmma<kArm>         ? kBlockQ * kMmaRow * sizeof(double)
    : kIsInt<kArm>          ? kBlockQ * kImmaRow
    : kArm == Arm::kDefault ? kBlockQ * kMmaRow * sizeof(__nv_bfloat16)
                            : 2 * kBlockQ * kMmaRow * sizeof(__nv_bfloat16);
// int4's unpacked db rows [128][kImmaRow] int8
template <Arm kArm>
constexpr size_t kMmaUnpackBytes =
    kArm == Arm::kInt4 ? kBinW * kImmaRow : 0;
// the score tile S (binned_select.cuh), then (the f32 family) the group's
// row norms [128] f32, which lane binning reads beside it
template <Arm kArm>
constexpr size_t kMmaScoreBytes =
    kScoreTileBytes + (kIsInt<kArm> ? 0 : kBinW * sizeof(float));
// dynamic shared memory of a CTA, one CTA per SM, at Dp = 128 / above:
// bf16x3, bf16x3f 174,080 / 206,848 B; highest 191,488 / 224,256 B;
// default 165,376 / 230,912 B; int8 99,328 / 117,760 B; int4 76,800 /
// 95,232 B
template <Arm kArm, bool kMulti>
constexpr size_t kMmaSmemBytes = kRing<kArm> * kMmaStageBytes<kArm, kMulti> +
                                 kMmaQBytes<kArm> + kMmaUnpackBytes<kArm> +
                                 kMmaScoreBytes<kArm>;
// the largest, with the kernels' static warp_ok[8], inside an SM's 227 KB
static_assert(kMmaSmemBytes<Arm::kDefault, true> + 64 <= 227 * 1024,
              "default CTA too large");
static_assert(kMmaSmemBytes<Arm::kHighest, true> + 64 <= 227 * 1024,
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

// Waits until at most kPending of this thread's committed copy groups are
// still in flight.
template <int kPending = 0>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

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

// d += a . b on the s8 tensor cores (m16n8k32, exact int32): with g = lane
// / 4, t = lane % 4, a = A[g][4t..4t+3], A[g+8][4t..], A[g][16+4t..],
// A[g+8][16+4t..] of the 16 x 32 int8 row fragment (4 bytes a register),
// (b0, b1) = B[4t..4t+3][g], B[16+4t..][g] of the 32 x 8 column fragment,
// d as mma_bf16's.  The fragments are ldmatrix's of 16-byte rows, as for
// bf16.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The copies of the int8 rows q0 .. q0+31 of the query block, dims c*128 ..
// c*128+127, into dst [32][kImmaRow] (rows past n_q zero-filled): one
// 16-byte segment a thread.
__device__ __forceinline__ void imma_query_copy(unsigned char* dst,
                                                const int8_t* __restrict__ qi,
                                                int c, int dp, int q0,
                                                int n_q, int tid) {
  constexpr int kSegs = kDimChunk / 16;
  static_assert(kBlockQ * kSegs == kThreads, "one segment a thread");
  const int r = tid / kSegs;
  const int seg = tid % kSegs;
  const bool live = q0 + r < n_q;
  cp_async16(dst + r * kImmaRow + seg * 16,
             qi + static_cast<size_t>(live ? q0 + r : 0) * dp +
                 c * kDimChunk + seg * 16,
             live ? 16 : 0);
}

// Starts the copies of one step: dims c*128 .. c*128+127 of db rows row0 ..
// row0+127 (th and tl bf16; default's th; highest's f32 t; int8 rows; int4's
// packed bytes), and (kWithQ) of the query rows q0 .. q0+31 (f32, or the
// int arms' int8; rows past n_q zero-filled).  q is the query operand, db0
// / db1 the db operands (db1 read by bf16x3 and bf16x3f alone); at the
// group's last chunk (c == nd - 1) the int arms also copy the group's row
// norms and row scales from aux [2, np] f32.
template <Arm kArm, bool kWithQ>
__device__ __forceinline__ void mma_start_stage(
    unsigned char* stage, const void* __restrict__ q,
    const void* __restrict__ db0, const void* __restrict__ db1,
    const float* __restrict__ aux, size_t np, size_t row0, int c, int dp,
    int q0, int n_q, int tid) {
  if constexpr (kIsInt<kArm>) {
    if (c == dp / kDimChunk - 1 && tid < 2 * kBinW / 4) {
      // 16 bytes a thread: norms by threads 0-31, scales by 32-63
      const int part = tid / (kBinW / 4), seg = tid % (kBinW / 4);
      cp_async16(stage + kMmaStageBytes<kArm, kWithQ> - kMmaRowsBytes<kArm> +
                     (part * kBinW + seg * 4) * sizeof(float),
                 aux + part * np + row0 + seg * 4, 16);
    }
    constexpr int kBytes = db_row_bytes<kArm>(kDimChunk);   // per chunk row
    constexpr int kSegs = kBytes / 16;
    constexpr int kPitch = kArm == Arm::kInt8 ? kImmaRow : kBytes;
    const uint8_t* t = static_cast<const uint8_t*>(db0);
    const size_t row_bytes = db_row_bytes<kArm>(dp);
#pragma unroll
    for (int p = 0; p < kBinW * kSegs / kThreads; ++p) {
      const int idx = tid + p * kThreads;
      const int r = idx / kSegs;
      const int seg = idx % kSegs;
      cp_async16(stage + r * kPitch + seg * 16,
                 t + (row0 + r) * row_bytes + c * kBytes + seg * 16, 16);
    }
    if constexpr (kWithQ)
      imma_query_copy(stage + kMmaDbBytes<kArm>, static_cast<const int8_t*>(q),
                      c, dp, q0, n_q, tid);
    return;
  } else {
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
        if constexpr (kArm != Arm::kDefault)
          cp_async16(stl + r * kMmaRow + seg * 8, tl + off, 16);
      }
    }
    if constexpr (kWithQ) {
      float* sq = reinterpret_cast<float*>(stage + kMmaDbBytes<kArm>);
      const float* qf = static_cast<const float*>(q);
      constexpr int kQSegs = kDimChunk / 4;
#pragma unroll
      for (int p = 0; p < kBlockQ * kQSegs / kThreads; ++p) {
        const int idx = tid + p * kThreads;
        const int r = idx / kQSegs;
        const int seg = idx % kQSegs;
        const bool live = q0 + r < n_q;
        const float* src = qf + static_cast<size_t>(live ? q0 + r : 0) * dp +
                           c * kDimChunk + seg * 4;
        cp_async16(sq + r * kDimChunk + seg * 4, src, live ? 16 : 0);
      }
    }
  }
}

// The query block's operand of one chunk, from f32 rows at src (row stride
// ``stride`` floats; rows at or past ``live`` read as zeros), into qs: the
// bf16 parts hi = bf16_rn(x) and lo = bf16_rn(x - hi) (the subtraction is
// exact) at qs and qs + 32 rows (default: hi alone), or (highest) x as f64
// (exact).
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
        if constexpr (kArm != Arm::kDefault)
          ql[at + e] =
              __float2bfloat16_rn(__fsub_rn(xs[e], __bfloat162float(h)));
      }
    }
  }
}

// int4: a staged chunk's packed rows [128][64] (byte j: dim j in the low
// nibble, dim 64 + j in the high one, both biased +8) unpacked into int8
// rows [128][kImmaRow], the layout an int8 stage holds.
__device__ __forceinline__ void imma_unpack_int4(const unsigned char* packed,
                                                 unsigned char* out, int tid) {
  constexpr int kBytes = db_row_bytes<Arm::kInt4>(kDimChunk);   // 64
  constexpr int kSegs = kBytes / 16;
#pragma unroll
  for (int p = 0; p < kBinW * kSegs / kThreads; ++p) {
    const int idx = tid + p * kThreads;
    const int r = idx / kSegs;
    const int seg = idx % kSegs;
    const uint4 v =
        *reinterpret_cast<const uint4*>(packed + r * kBytes + seg * 16);
    int4 lo, hi;
    unpack_int4(v.x, lo.x, hi.x);
    unpack_int4(v.y, lo.y, hi.y);
    unpack_int4(v.z, lo.z, hi.z);
    unpack_int4(v.w, lo.w, hi.w);
    unsigned char* row = out + r * kImmaRow + seg * 16;
    *reinterpret_cast<int4*>(row) = lo;
    *reinterpret_cast<int4*>(row + kDimChunk / 2) = hi;
  }
}

// The accumulators of a warp's 16 db rows x 32 queries: [n-tile][4].
// bf16x3 keeps two; bf16x3f and default one, ``hi`` alone.
struct MmaAcc {
  float hi[4][4];   // qh . th (bf16x3f: every product)
  float lo[4][4];   // qh . tl + ql . th (bf16x3 only)
};

// One staged chunk's products into ``acc`` (zeroed here): 8 k-steps in
// dim order; per step and n-tile th.qh, tl.qh, th.ql -- into hi, lo, lo
// (bf16x3), or all three into hi (bf16x3f: 24 steps a chunk into one
// accumulator, the TPU's one dot over the 3x contraction) -- or th.qh
// alone into hi (default).
template <Arm kArm>
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* sth,
                                          const __nv_bfloat16* stl,
                                          const __nv_bfloat16* qh,
                                          const __nv_bfloat16* ql, int warp,
                                          int lane, MmaAcc& acc) {
  constexpr bool kThree = kArm != Arm::kDefault;   // three products a step
  constexpr bool kOne = kArm != Arm::kBf16x3;      // one accumulator
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
    if constexpr (kThree) ldsm_x4(al, stl + a_off + kk * kMmaK);
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      ldsm_x4(bh[pr], qh + pr * 16 * kMmaRow + b_off + kk * kMmaK);
      if constexpr (kThree)
        ldsm_x4(bl[pr], ql + pr * 16 * kMmaRow + b_off + kk * kMmaK);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int pr = nt / 2, h = 2 * (nt % 2);
      mma_bf16(acc.hi[nt], ah, bh[pr][h], bh[pr][h + 1]);
      if constexpr (kThree) {
        float (&second)[4] = *(kOne ? &acc.hi[nt] : &acc.lo[nt]);
        mma_bf16(second, al, bh[pr][h], bh[pr][h + 1]);
        mma_bf16(second, ah, bl[pr][h], bl[pr][h + 1]);
      }
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

// The chunk's sum (bf16x3: hi + lo, one f32 add; bf16x3f, default: hi)
// into S.
template <Arm kArm>
__device__ __forceinline__ void mma_store_chunk(const MmaAcc& acc, float* S,
                                                int warp, int lane,
                                                bool first) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store_score(S, nt * 8 + 2 * t + (e & 1), warp * 16 + g + (e >> 1) * 8,
                  kArm != Arm::kBf16x3
                      ? acc.hi[nt][e]
                      : __fadd_rn(acc.hi[nt][e], acc.lo[nt][e]),
                  first);
}

// highest: one staged chunk (db rows st [128][kMmaRow] f32, the query qd
// [32][kMmaRow] f64) on the FP64 tensor cores, 16 m16n8k8 steps in dim
// order into one f64 accumulator per cell, each rounded once to f32 into
// S.  Step s: fragment slot t holds dim 8s + 2t, slot t + 4 dim 8s + 2t + 1
// (one float2 per db row, one double2 per query).  kParts: the 4 n-tiles
// in that many parts, each its own walk of the 16 steps (the db fragments
// loaded once a part): the deep builds take 4, 8 accumulator registers in
// place of 32, for their emitter state (with fewer parts their 76-88
// registers of it spill); every cell's sum is the same.
template <int kParts>
__device__ __forceinline__ void dmma_chunk(const float* st, const double* qd,
                                           int warp, int lane, float* S,
                                           bool first) {
  constexpr int kTiles = 4 / kParts;   // n-tiles a part
  const int g = lane >> 2, t = lane & 3;
  const float* a_lo = st + (warp * 16 + g) * kMmaRow + 2 * t;
  const float* a_hi = a_lo + 8 * kMmaRow;
  const double* b = qd + g * kMmaRow + 2 * t;
#pragma unroll
  for (int part = 0; part < kParts; ++part) {
    double acc[kTiles][4];
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0;
#pragma unroll
    for (int s = 0; s < kDimChunk / kDmmaK; ++s) {
      const float2 lo = *reinterpret_cast<const float2*>(a_lo + kDmmaK * s);
      const float2 hi = *reinterpret_cast<const float2*>(a_hi + kDmmaK * s);
      const double a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const double2 bv = *reinterpret_cast<const double2*>(
            b + (part * kTiles + nt) * 8 * kMmaRow + kDmmaK * s);
        mma_f64(acc[nt], a, bv.x, bv.y);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_score(S, (part * kTiles + nt) * 8 + 2 * t + (e & 1),
                    warp * 16 + g + (e >> 1) * 8,
                    __double2float_rn(acc[nt][e]), first);
  }
}

// The B fragments of one 128-dim chunk of the query rows qi [32][kImmaRow]
// int8 for every k-step: [k-step][query pair][4] (ldmatrix.x4 of 16-byte
// rows: a pair's 16 queries x 32 dims, two n-tiles).
using ImmaQFrags = uint32_t[kDimChunk / kImmaK][2][4];

__device__ __forceinline__ void imma_query_frags(const unsigned char* qi,
                                                 int lane, ImmaQFrags& b) {
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * kImmaRow +
                    ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int kk = 0; kk < kDimChunk / kImmaK; ++kk)
#pragma unroll
    for (int pr = 0; pr < 2; ++pr)
      ldsm_x4(b[kk][pr], qi + pr * 16 * kImmaRow + b_off + kk * kImmaK);
}

// int8 / int4: one staged chunk's products (db rows st [128][kImmaRow]
// int8, the query's fragments b) added into the int32 accumulators acc
// [n-tile][4]: 4 m16n8k32 k-steps, the A fragments loaded with ldmatrix as
// bf16's are (a 16-byte row of 8 bf16 is one of 16 int8).
__device__ __forceinline__ void imma_chunk(const unsigned char* st,
                                           const ImmaQFrags& b, int warp,
                                           int lane, int (&acc)[4][4]) {
  const int a_off = (warp * 16 + (lane & 15)) * kImmaRow + (lane >> 4) * 16;
#pragma unroll
  for (int kk = 0; kk < kDimChunk / kImmaK; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, st + a_off + kk * kImmaK);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int pr = nt / 2, h = 2 * (nt % 2);
      mma_s8(acc[nt], a, b[kk][pr][h], b[kk][pr][h + 1]);
    }
  }
}

// Every entry's walk but pq's: db tiles [t_begin, t_end) for the query
// block at q0, each tile's groups, each group's chunks, through the ring;
// the group's scores to the emitter; at each tile's end K11's skip (kFused,
// depth > 0) and the tile's block.  Operands p0 .. p3 as the C entries take
// them (binned_coarse.cu): the f32 family q [n_q, dp] f32, its db operands
// (th, tl bf16; default th and NULL; highest t f32 and NULL), tnorm row 0
// of the [8, Np] norm rows; the int arms qi [n_q, dp] int8, qsc [n_q] f32,
// t (int8 [Np, dp] or packed [Np, dp/2]), aux [2, Np] f32 (row norms, then
// row scales).
template <Arm kArm, bool kMulti, int kDepth, bool kFused>
__device__ __forceinline__ void mma_walk(
    const void* __restrict__ p0, const void* __restrict__ p1,
    const void* __restrict__ p2, const float* __restrict__ p3,
    const Out& out, int dp, int q0, int t_begin, int t_end, int depth,
    unsigned char* smem, int* warp_ok) {
  static_assert(!(kFused && kDepth > 0), "the fused early-out is grouped only");
  static_assert(kUsesMma<kArm>, "pq runs binned_pq.cuh's walk");
  constexpr bool kInt = kIsInt<kArm>;
  constexpr int kStages = kRing<kArm>;
  constexpr size_t kStage = kMmaStageBytes<kArm, kMulti>;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const Place place{q0, warp, lane};
  const int n_q = out.n_q;
  const int tile_n = out.tile_n;
  const int n_groups = tile_n / kBinW;
  const int nd = dp / kDimChunk;
  // the operands: the int arms read (qi, qsc, t, aux), the f32 family (q,
  // db0, db1, tnorm)
  const void* db0 = kInt ? p2 : p1;
  const void* db1 = kInt ? nullptr : p2;
  const float* tnorm = p3;
  const size_t n_rows = static_cast<size_t>(out.n_tiles) * tile_n;
  // a deep grouped build walks each tile once per pass, kQuadQ / kPasses
  // rows of the threads' quads a pass, sized from its state (binned_select.
  // cuh's build table: one pass at 1, 3 and 4 survivors, 16 cells of 3-6
  // registers, 8-bit group indices packed four to a register below 257
  // groups a tile; two at 5-8, 8 cells of 11; four past 256 groups, 4
  // cells of 17 with int indices): every pass stages the tile's chunks and
  // runs its products again
  using Em = EmitterOf<kDepth>;
  constexpr bool kDeep = kDepth < 0;
  constexpr int kPasses = Em::kPasses;
  unsigned char* qs = smem + kStages * kStage;
  unsigned char* unpacked = qs + kMmaQBytes<kArm>;   // int4's int8 rows
  float* S = reinterpret_cast<float*>(unpacked + kMmaUnpackBytes<kArm>);
  // the int arms: the scales of this thread's fragment queries, n-tile
  // n's q0 + n*8 + 2 (lane % 4) + b (0 past n_q: never written)
  float qsc[4][2];
  if constexpr (kInt) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int row = q0 + n * 8 + 2 * (lane & 3) + b;
        qsc[n][b] = row < n_q ? static_cast<const float*>(p1)[row] : 0.0f;
      }
  }

  // Dp = 128: the query block's operand once (visible after the first
  // step's wait and barrier: the int8 rows join its copy group)
  if constexpr (!kMulti) {
    if constexpr (kInt)
      imma_query_copy(qs, static_cast<const int8_t*>(p0), 0, dp, q0, n_q, tid);
    else
      mma_query<kArm>(static_cast<const float*>(p0) +
                          static_cast<size_t>(q0) * dp,
                      dp, n_q - q0, qs, tid);
  }

  // the next step to stage: (tile nt, pass npass, group ng, chunk nc)
  int nt = t_begin, npass = 0, ng = 0, nc = 0;
  auto stage_next = [&](unsigned char* st) {
    const size_t row0 =
        static_cast<size_t>(nt) * tile_n + static_cast<size_t>(ng) * kBinW;
    mma_start_stage<kArm, kMulti>(st, p0, db0, db1, p3, n_rows, row0, nc, dp,
                                  q0, n_q, tid);
    if (++nc == nd) {
      nc = 0;
      if (++ng == n_groups) {
        ng = 0;
        if (++npass == kPasses) {
          npass = 0;
          ++nt;
        }
      }
    }
  };
  // the first kStages - 1 steps in flight, one copy group each (empty past
  // the run's end, so the count of groups stays one a step)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (nt < t_end) stage_next(smem + s * kStage);
    cp_async_commit();
  }
  int buf = 0;
  // the int arms at Dp = 128: the query's fragments stay in registers for
  // the whole walk, once its copy group (the first) has landed
  ImmaQFrags qfrag;
  if constexpr (kInt && !kMulti) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    imma_query_frags(qs, lane, qfrag);
  }

  const int frag_row = warp * 16 + (lane >> 2);   // and frag_row + 8
  float carry[kQuadQ][kQuadL][kMaxCarry];
  if constexpr (kFused) reset_carry(carry, depth);
  Em em(S);
  for (int ti = t_begin; ti < t_end; ++ti) {
    for (int pass = 0; pass < kPasses; ++pass) {
      em.begin_pass(pass);
      for (int g = 0; g < n_groups; ++g) {
        const size_t row0 =
            static_cast<size_t>(ti) * tile_n + static_cast<size_t>(g) * kBinW;
        int iacc[4][4];   // the int arms' exact dot over every chunk
        // the f32 family: the norms of the emitters' rows lane + 32 j; the
        // int arms: the norms and scales of the fragment rows
        float tn[kQuadL], ts[2];
        for (int c = 0; c < nd; ++c) {
          // this step's stage has landed (every thread's copies); the stage
          // the next copies go to, the query operand, the unpacked rows and
          // S are no longer read
          cp_async_wait<kStages - 2>();
          __syncthreads();
          if (nt < t_end)
            stage_next(smem + (buf + kStages - 1) % kStages * kStage);
          cp_async_commit();
          const unsigned char* st = smem + buf * kStage;
          // the group's norms, in flight during its last chunk's products
          // (the int arms': in that chunk's stage, with its row scales)
          if (c == nd - 1) {
            if constexpr (kInt) {
              const float* rows = reinterpret_cast<const float*>(
                  st + kStage - kMmaRowsBytes<kArm>);
              tn[0] = rows[frag_row];
              tn[1] = rows[frag_row + 8];
              ts[0] = rows[kBinW + frag_row];
              ts[1] = rows[kBinW + frag_row + 8];
            } else {
              load_group_rows(tnorm, row0, lane, tn);
            }
          }
          if constexpr (kInt) {
            if constexpr (kArm == Arm::kInt4) {
              imma_unpack_int4(st, unpacked, tid);
              __syncthreads();
            }
            if (c == 0) {
#pragma unroll
              for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) iacc[n][e] = 0;
            }
            if constexpr (kMulti)
              imma_query_frags(st + kMmaDbBytes<kArm>, lane, qfrag);
            imma_chunk(kArm == Arm::kInt4 ? unpacked : st, qfrag, warp, lane,
                       iacc);
            if (c == nd - 1) {
              // the one f32 rounding, (f32_rn(dot) * qsc) * ts in the TPU
              // kernel's order (the _rn intrinsics: no contraction), then s
              const int gq = lane >> 2, t = lane & 3;
#pragma unroll
              for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  store_score(S, n * 8 + 2 * t + (e & 1),
                              warp * 16 + gq + (e >> 1) * 8,
                              tn[e >> 1] - 2.0f * __fmul_rn(
                                  __fmul_rn(__int2float_rn(iacc[n][e]),
                                            qsc[n][e & 1]),
                                  ts[e >> 1]),
                              true);
            }
          } else {
            if constexpr (kMulti) {
              mma_query<kArm>(
                  reinterpret_cast<const float*>(st + kMmaDbBytes<kArm>),
                  kDimChunk, kBlockQ, qs, tid);
              __syncthreads();
            }
            if constexpr (kUsesDmma<kArm>) {
              dmma_chunk<kDeep ? 4 : 1>(reinterpret_cast<const float*>(st),
                                        reinterpret_cast<const double*>(qs),
                                        warp, lane, S, c == 0);
            } else {
              const __nv_bfloat16* sth =
                  reinterpret_cast<const __nv_bfloat16*>(st);
              const __nv_bfloat16* qh =
                  reinterpret_cast<const __nv_bfloat16*>(qs);
              MmaAcc acc;
              mma_chunk<kArm>(sth, sth + kBinW * kMmaRow, qh,
                              qh + kBlockQ * kMmaRow, warp, lane, acc);
              mma_store_chunk<kArm>(acc, S, warp, lane, c == 0);
            }
          }
          buf = (buf + 1) % kStages;
        }
        // lane binning reads the f32 family's norms beside S
        float* tn_rows = S + kBlockQ * kScoreStride;
        if constexpr (kDepth > 0 && !kInt) {
          if (warp == 0) {
#pragma unroll
            for (int j = 0; j < kQuadL; ++j) tn_rows[lane + 32 * j] = tn[j];
          }
        }
        __syncthreads();   // S complete: qt (the int arms: the scores)
        if constexpr (kDepth > 0) {
          if constexpr (kInt)
            em.group_tile(S, [](int, float s) { return s; }, g, ti, out, place);
          else
            em.group_tile(S, [&](int r, float qt) {
              return tn_rows[r] - 2.0f * qt;
            }, g, ti, out, place);
        } else if constexpr (kDeep) {
          // this pass's rows of the thread's quad
          float a[Em::kRows][kQuadL];
#pragma unroll
          for (int r = 0; r < Em::kRows; ++r)
#pragma unroll
            for (int j = 0; j < kQuadL; ++j) {
              const float v = S[(warp * kQuadQ + pass * Em::kRows + r) *
                                    kScoreStride +
                                lane + 32 * j];
              a[r][j] = kInt ? v : tn[j] - 2.0f * v;
            }
          em.group_rows(a, g, out.geo.surv);
        } else {
          Acc a;
#pragma unroll
          for (int i = 0; i < kQuadQ; ++i)
#pragma unroll
            for (int j = 0; j < kQuadL; ++j) {
              const float v =
                  S[(warp * kQuadQ + i) * kScoreStride + lane + 32 * j];
              a[i][j] = kInt ? v : tn[j] - 2.0f * v;
            }
          em.group(a, g, ti, out, place);
        }
      }
      em.end_pass(ti, out, place);
      if constexpr (kFused && kDeep) fused_pass(em, carry, depth);
    }
    bool skip = false;
    if constexpr (kFused)
      skip = fused_skip(em, carry, depth, place, n_q, warp_ok);
    em.end_tile(ti, out, place, skip);
  }
}

// One k-step on its own, for the rounding probe: d = c + a . b^T with a
// [16][16] bf16 (row, k), b [8][16] bf16 (n, k), c and d [16][8] f32, all
// row-major in global memory; one warp.  (static: each arm's part of a
// library has its own copy.)
static __global__ void mma_probe_kernel(const __nv_bfloat16* __restrict__ a,
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
static __global__ void dmma_probe_kernel(const double* __restrict__ a,
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
