// Kernel G: uniform canonical Goldilocks felts by Philox4x64-10.
//
// Replaces the JAX package's plonk/prover_fused.py::_rand_felts_j, the jnp
// device function that draws a device-rng ZK proof's blinding rows and
// oracle salts (threefry bits, two draws and a select). On Hopper the
// generator is Philox4x64-10, counter-based, so each thread computes its
// own block with no state: key (proof key, stream), counter (b, 0, 0, 0),
// and block b gives felts 2b and 2b + 1, each its first word if below p,
// else its second reduced by one conditional subtract (field/random.py
// states the mapping; its plain version equals numpy's Philox).
//
// Bound on the H100: operations. A block does 19 64x64->128 products (the
// counter's upper words are 0, so round 1 has one), 76 IMAD.WIDE on the FMA
// pipe, beside 19 three-way 64-bit xors and the selects on the ALU pipe
// (the key schedule is the same for every block), for 16 bytes written: the
// FMA pipe bounds it, not the 8 bytes a felt written. The design is
// the simplest that is right: one thread a block, a grid-stride loop, the
// output written in place through its row and column strides (the trace's
// blinding columns are a strided view).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr uint64_t M0 = 0xD2E7470EE14C6C93ull, M1 = 0xCA5A826395121157ull;
constexpr uint64_t W0 = 0x9E3779B97F4A7C15ull, W1 = 0xBB67AE8584CAA73Bull;
__device__ __forceinline__ uint64_t select(uint64_t first, uint64_t second) {
  return first < gl::P ? first : (second >= gl::P ? second - gl::P : second);
}

__global__ void rand_felts_kernel(uint64_t* __restrict__ out, long long cols, long long rs,
                                  long long cs, long long count, uint64_t key, uint64_t stream) {
  const long long blocks = (count + 1) >> 1;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < blocks; b += step) {
    uint64_t c0 = (uint64_t)b, c1 = 0, c2 = 0, c3 = 0, k0 = key, k1 = stream;
#pragma unroll
    for (int r = 0; r < 10; ++r) {
      if (r) {
        k0 += W0;
        k1 += W1;
      }
      const uint64_t lo0 = M0 * c0, hi0 = __umul64hi(M0, c0);
      const uint64_t lo1 = M1 * c2, hi1 = __umul64hi(M1, c2);
      c0 = hi1 ^ c1 ^ k0;
      c1 = lo1;
      c2 = hi0 ^ c3 ^ k1;
      c3 = lo0;
    }
    long long i = 2 * b;
    out[(i / cols) * rs + (i % cols) * cs] = select(c0, c1);
    if (++i < count) out[(i / cols) * rs + (i % cols) * cs] = select(c2, c3);
  }
}

}  // namespace

// out: rows x cols felts at out[r * rs + c * cs] (element strides), felt
// i = r * cols + c; key, stream: the Philox key. Returns a cudaError_t.
extern "C" int qzk_rand_felts(void* out, long long rows, long long cols, long long rs,
                              long long cs, unsigned long long key, unsigned long long stream,
                              void* stream_ptr) {
  if (rows <= 0 || cols <= 0) return 0;
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  const long long count = rows * cols;
  const int threads = 256;
  long long grid = ((count + 1) / 2 + threads - 1) / threads;
  if (grid > 8192) grid = 8192;
  rand_felts_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream_ptr>>>(
      (uint64_t*)out, cols, rs, cs, count, (uint64_t)key, (uint64_t)stream);
  return (int)cudaGetLastError();
}
