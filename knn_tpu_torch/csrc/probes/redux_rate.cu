// Microbenchmark: the cost of a warp-wide unsigned minimum on this card, as
// the lane emitter (binned_select.cuh, K8) takes it -- one __reduce_min_sync
// (redux.sync) -- against a 5-level __shfl_xor_sync butterfly and a single
// shuffle.  Each warp runs a loop of four independent reductions; the line
// printed per kind and CTA size is SM cycles per warp-wide reduction (the
// SM's whole throughput, every warp of every CTA counted).  Build and run
// with run.sh.

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

template <int kKind>
__global__ void bench(unsigned* out, int iters) {
  unsigned v[4];
  for (int i = 0; i < 4; ++i) v[i] = threadIdx.x * 2654435761u + i * 40503u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kKind == 0) v[i] = __reduce_min_sync(0xffffffffu, v[i]) + threadIdx.x;
      if (kKind == 1) {
        unsigned m = v[i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
        v[i] = m + threadIdx.x;
      }
      if (kKind == 2) v[i] = __shfl_xor_sync(0xffffffffu, v[i], 1) + threadIdx.x;
    }
  }
  const unsigned a = v[0] ^ v[1] ^ v[2] ^ v[3];
  if (a == 0x12345u) out[0] = a;
}

int main() {
  unsigned* o;
  CK(cudaMalloc(&o, sizeof(unsigned)));
  int sms, khz;
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  CK(cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0));
  cudaEvent_t e0, e1;
  CK(cudaEventCreate(&e0));
  CK(cudaEventCreate(&e1));
  const char* names[3] = {"redux_min", "shfl_butterfly_5", "one_shfl"};
  void (*fns[3])(unsigned*, int) = {bench<0>, bench<1>, bench<2>};
  const int iters = 20000;
  for (int warps : {8, 16})
    for (int k = 0; k < 3; ++k) {
      fns[k]<<<sms, 32 * warps>>>(o, 10);
      CK(cudaDeviceSynchronize());
      CK(cudaEventRecord(e0));
      fns[k]<<<sms, 32 * warps>>>(o, iters);
      CK(cudaEventRecord(e1));
      CK(cudaEventSynchronize(e1));
      float ms;
      CK(cudaEventElapsedTime(&ms, e0, e1));
      const double reductions = 4.0 * iters * warps;   // per SM
      printf("{\"kind\": \"%s\", \"warps_per_cta\": %d, "
             "\"sm_cycles_per_reduction\": %.3f}\n",
             names[k], warps, ms * 1e-3 * khz * 1e3 / reductions);
    }
  return 0;
}
