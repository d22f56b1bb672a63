// Microbenchmark: the FP64 tensor-core MMA shapes on this card.  For each of
// mma.sync m8n8k4, m16n8k4, m16n8k8 and m16n8k16 (f64 in, f64 accumulate)
// it checks the fragment layout the highest kernels assume (one warp, exact
// small-integer operands against a host product) and times a loop of
// independent MMAs held in registers (no memory traffic), printing one JSON
// line per shape and CTA size: layout mismatches and TFLOP/s.  It picked
// m16n8k8 for binned_mma.cuh's highest walk (m8n8k4 runs at half the rate
// of the others on an H100).  Build and run with run.sh.

#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>

#define CK(x)                                                       \
  do {                                                              \
    cudaError_t e = (x);                                            \
    if (e != cudaSuccess) {                                         \
      printf("cuda error %s at line %d\n", cudaGetErrorString(e),   \
             __LINE__);                                             \
      exit(1);                                                      \
    }                                                               \
  } while (0)

// Shape (M, K) with N = 8: A fragment a[i] = A[g + 8 (i & 1)][t + 4 (i >> 1)]
// (M = 16) or A[g][t] (M = 8), B fragment b[i] = B[t + 4 i][g], C fragment
// c[i] = C[g + 8 (i / 2)][2 t + (i & 1)], with g = lane / 4, t = lane % 4.
template <int M, int K>
struct Shape {
  static constexpr int kA = M * K / 32, kB = K / 4, kC = M * 8 / 32;
  __device__ static void mma(double (&d)[kC], const double (&a)[kA],
                             const double (&b)[kB]);
  __device__ static void a_at(int lane, int i, int& r, int& k) {
    const int g = lane >> 2, t = lane & 3;
    r = g + (M == 16 ? 8 * (i & 1) : 0);
    k = t + 4 * (M == 16 ? i >> 1 : i);
  }
};

template <>
__device__ void Shape<8, 4>::mma(double (&d)[2], const double (&a)[1],
                                 const double (&b)[1]) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, "
               "{%2}, {%3}, {%0,%1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a[0]), "d"(b[0]));
}
template <>
__device__ void Shape<16, 4>::mma(double (&d)[4], const double (&a)[2],
                                  const double (&b)[1]) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
               "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
template <>
__device__ void Shape<16, 8>::mma(double (&d)[4], const double (&a)[4],
                                  const double (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
                 "d"(b[1]));
}
template <>
__device__ void Shape<16, 16>::mma(double (&d)[4], const double (&a)[8],
                                   const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, "
               "{%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
                 "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
                 "d"(b[2]), "d"(b[3]));
}

// D = A . B^T, A [M][K], B [8][K] (n, k), D [M][8], all row-major.
template <class S, int M, int K>
__global__ void layout(const double* A, const double* B, double* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[S::kA], b[S::kB], d[S::kC] = {};
  for (int i = 0; i < S::kA; ++i) {
    int r, k;
    S::a_at(lane, i, r, k);
    a[i] = A[r * K + k];
  }
  for (int i = 0; i < S::kB; ++i) b[i] = B[g * K + t + 4 * i];
  S::mma(d, a, b);
  for (int i = 0; i < S::kC; ++i)
    D[(g + 8 * (i / 2)) * 8 + 2 * t + (i & 1)] = d[i];
}

// Eight independent accumulators per warp, `iters` MMAs each.
template <class S>
__global__ void rate(double* out, int iters) {
  double a[S::kA], b[S::kB], d[8][S::kC] = {};
  for (int i = 0; i < S::kA; ++i) a[i] = 1.0 + threadIdx.x * 1e-3 + i;
  for (int i = 0; i < S::kB; ++i) b[i] = 1.0 - threadIdx.x * 1e-3 + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < 8; ++s) S::mma(d[s], a, b);
  }
  double acc = 0;
  for (int s = 0; s < 8; ++s)
    for (int i = 0; i < S::kC; ++i) acc += d[s][i];
  if (acc == 12345.0) out[0] = acc;
}

template <int M, int K>
void run(const char* name) {
  using S = Shape<M, K>;
  double hA[M * K], hB[8 * K], hD[M * 8];
  for (int i = 0; i < M * K; ++i) hA[i] = (i * 7 % 13) - 6;
  for (int i = 0; i < 8 * K; ++i) hB[i] = (i * 5 % 11) - 5;
  double *dA, *dB, *dD, *o;
  CK(cudaMalloc(&dA, sizeof hA));
  CK(cudaMalloc(&dB, sizeof hB));
  CK(cudaMalloc(&dD, sizeof hD));
  CK(cudaMalloc(&o, sizeof(double)));
  CK(cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice));
  layout<S, M, K><<<1, 32>>>(dA, dB, dD);
  CK(cudaGetLastError());
  CK(cudaMemcpy(hD, dD, sizeof hD, cudaMemcpyDeviceToHost));
  int bad = 0;
  for (int r = 0; r < M; ++r)
    for (int n = 0; n < 8; ++n) {
      double s = 0;
      for (int k = 0; k < K; ++k) s += hA[r * K + k] * hB[n * K + k];
      bad += hD[r * 8 + n] != s;
    }
  int sms;
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  cudaEvent_t e0, e1;
  CK(cudaEventCreate(&e0));
  CK(cudaEventCreate(&e1));
  const int iters = 4096;
  for (int warps : {4, 8}) {
    rate<S><<<sms, 32 * warps>>>(o, 16);
    CK(cudaDeviceSynchronize());
    CK(cudaEventRecord(e0));
    rate<S><<<2 * sms, 32 * warps>>>(o, iters);
    CK(cudaEventRecord(e1));
    CK(cudaEventSynchronize(e1));
    float ms;
    CK(cudaEventElapsedTime(&ms, e0, e1));
    const double flops = 2.0 * M * 8 * K * 8.0 * iters * warps * sms * 2;
    printf("{\"shape\": \"%s\", \"layout_mismatches\": %d, "
           "\"warps_per_cta\": %d, \"tflops\": %.2f}\n",
           name, bad, warps, flops / ms / 1e9);
  }
}

int main() {
  run<8, 4>("m8n8k4");
  run<16, 4>("m16n8k4");
  run<16, 8>("m16n8k8");
  run<16, 16>("m16n8k16");
  return 0;
}
