// Latency of one dependent Goldilocks multiply, add and warp shuffle on the
// card, in SM clock cycles (clock64 around a chain of n of each, one warp).
// Built and run by tools/field_latency.py; not part of the kernel library.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

__global__ void chains(unsigned long long* sink, long long* cycles, uint64_t a, uint64_t b,
                       int n) {
  uint64_t x = a, y = a, z = a;
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) x = gl::mul(x, b);
  const long long t1 = clock64();
  for (int i = 0; i < n; ++i) y = gl::add(y, b);
  const long long t2 = clock64();
  for (int i = 0; i < n; ++i) {
    z = (uint64_t)__shfl_sync(0xffffffffu, (unsigned long long)gl::add(z, b), (threadIdx.x + 1) & 31);
  }
  const long long t3 = clock64();
  sink[threadIdx.x] = x ^ y ^ z;  // keeps the chains
  if (threadIdx.x == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = t2 - t1;
    cycles[2] = t3 - t2;
  }
}

}  // namespace

// sink: 32 u64; cycles: 3 i64 (mul, add, shuffle + add chains); one warp.
extern "C" int qzk_field_latency(void* sink, void* cycles, int n) {
  chains<<<1, 32>>>((unsigned long long*)sink, (long long*)cycles, 12345, 0xFFFFFFFF00000000ull, n);
  cudaError_t e = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : cudaDeviceSynchronize());
}
