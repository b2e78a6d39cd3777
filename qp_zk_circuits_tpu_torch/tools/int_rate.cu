// Throughput of the integer instructions kernel G is made of, in lanes an
// SM a clock: 32 warps an SM run 8 interleaved chains a thread of one
// instruction (mad.wide.u32: IMAD.WIDE.U32; mad.lo.u32: IMAD; mad.hi.u32:
// IMAD.HI.U32; a three-way xor: LOP3; IMAD.WIDE and LOP3 in turn), each
// link reading the neighbouring chain's last value so that none folds;
// clock64 around the loop in each block. Built and run by
// tools/int_rate.py; not part of the kernel library.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAINS = 8;

template <int OP>
__global__ void __launch_bounds__(1024) rate(unsigned long long* sink, long long* cycles,
                                             uint32_t c, int n) {
  uint64_t w[CHAINS];
  uint32_t a[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) {
    w[k] = threadIdx.x * 0x9E3779B97F4A7C15ull + k;
    a[k] = threadIdx.x * 0x85EBCA6Bu + k;
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
      const int nb = (k + 1) % CHAINS;
      if (OP == 0 || OP == 4) {
        asm volatile("mad.wide.u32 %0, %1, %2, %3;"
                     : "=l"(w[k]) : "r"((uint32_t)w[k]), "r"(c), "l"(w[nb]));
      }
      if (OP == 1) asm volatile("mad.lo.u32 %0, %1, %2, %3;" : "=r"(a[k]) : "r"(a[k]), "r"(c), "r"(a[nb]));
      if (OP == 2) asm volatile("mad.hi.u32 %0, %1, %2, %3;" : "=r"(a[k]) : "r"(a[k]), "r"(c), "r"(a[nb]));
      if (OP == 3 || OP == 4) {
        asm volatile("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(a[k]) : "r"(a[k]), "r"(a[nb]), "r"(c));
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint64_t x = 0;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) x ^= w[k] ^ a[k];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = x;  // keeps the chains
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

// sink: blocks * 1024 u64; cycles: blocks i64; op 0..4 as above. One block
// of 1024 threads an SM when blocks is the SM count.
extern "C" int qzk_int_rate(void* sink, void* cycles, int op, int blocks, int n) {
  auto s = (unsigned long long*)sink;
  auto cy = (long long*)cycles;
  const uint32_t c = 0xD2E7470Eu;
  switch (op) {
    case 0: rate<0><<<blocks, 1024>>>(s, cy, c, n); break;
    case 1: rate<1><<<blocks, 1024>>>(s, cy, c, n); break;
    case 2: rate<2><<<blocks, 1024>>>(s, cy, c, n); break;
    case 3: rate<3><<<blocks, 1024>>>(s, cy, c, n); break;
    default: rate<4><<<blocks, 1024>>>(s, cy, c, n); break;
  }
  cudaError_t e = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : cudaDeviceSynchronize());
}
