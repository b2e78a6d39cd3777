// Kernel H: the two local steps of the coefficient-sharded NTT.
//
// Replaces the jnp transposes and the length-D `ntt_j` over n1 inside the
// JAX package's poly/ntt.py::_ntt_shard_body (the four-step NTT of one
// polynomial of N = D * L coefficients spread in contiguous blocks of L over
// D devices). A shard's other steps are kernel 3 (the length-L NTT, its
// twiddle row w_N^(p k2) folded in as the output multiplier) and the copies
// of parallel/collectives.py; poly/ntt.py::ntt_sharded drives them.
//
//   qzk_shard_deinterleave: x (L,) read as (L/D, D) -> out (D, L/D), row r the
//     coefficients x[q D + r]: the block -> cyclic regrouping, each row the
//     slab that goes to shard r.
//   qzk_shard_cross_ntt: z (D, L/D) -> W (D, L/D), W[k1, t] = sum_n1 z[n1, t]
//     w_D^(+-n1 k1), times 1/D for the inverse (folded into the roots): the
//     length-D DFT across the received slab, row k1 the slab for shard k1.
//
// Bound on the H100: bytes. Each entry reads L felts and writes L: at N =
// 2^24 over D = 4 shards, 64 MiB a shard, 0.020 ms at 3.35 TB/s. The DFT's
// least work is a radix-2 transform, (D/2) log2 D multiplies a column, far
// below the integer rate for D <= 8. The design is the simplest that is
// right: the deinterleave stages a tile of consecutive input felts in shared
// memory (coalesced reads) and writes runs of L/D-contiguous rows (coalesced
// writes); the DFT takes one thread a (column, k1) pair, the D inputs of a
// column read across t by neighbouring threads, D multiply-adds with the
// roots passed by value (no table upload), the direct sum and not the
// butterflies.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int MAX_D_BITS = 6;  // at most 64 shards (poly/ntt.py MAX_SHARDS)
constexpr int TILE_BITS = 11;  // a deinterleave block's felts: 16 KB of shared memory
constexpr int THREADS = 256;

struct Roots {
  uint64_t w[1 << MAX_D_BITS];  // w_D^(+-j), times 1/D for the inverse
};

// Block b takes input felts [b 2^tile_bits, (b + 1) 2^tile_bits): its q-rows
// [b tq, (b + 1) tq) of every residue r, tq = 2^(tile_bits - d_bits).
__global__ void deinterleave_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
                                    long long rows, int d_bits, int tq_bits) {
  __shared__ uint64_t tile[1 << TILE_BITS];
  const int count = 1 << (tq_bits + d_bits);
  const long long q0 = (long long)blockIdx.x << tq_bits;
  const uint64_t* src = x + (q0 << d_bits);
  for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = src[i];
  __syncthreads();
  const int tq_mask = (1 << tq_bits) - 1;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int r = i >> tq_bits, q = i & tq_mask;
    out[(long long)r * rows + q0 + q] = tile[(q << d_bits) + r];
  }
}

// Thread (t, k1 = blockIdx.y) writes W[k1, t].
__global__ void cross_ntt_kernel(const uint64_t* __restrict__ z, uint64_t* __restrict__ out,
                                 long long cols, int d_bits, const __grid_constant__ Roots roots) {
  const int d = 1 << d_bits, k1 = blockIdx.y;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < cols; t += step) {
    uint64_t acc = 0;
    for (int n1 = 0; n1 < d; ++n1) {
      acc = gl::add(acc, gl::mul(z[(long long)n1 * cols + t], roots.w[(n1 * k1) & (d - 1)]));
    }
    out[(long long)k1 * cols + t] = acc;
  }
}

}  // namespace

// x: L = rows << d_bits felts; out: (2^d_bits, rows). rows a power of two.
// Returns a cudaError_t.
extern "C" int qzk_shard_deinterleave(const void* x, void* out, long long rows, int d_bits,
                                      void* stream) {
  if (d_bits < 0 || d_bits > MAX_D_BITS || rows <= 0 || (rows & (rows - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int tq_bits = TILE_BITS - d_bits;
  while ((1ll << tq_bits) > rows) --tq_bits;
  const long long blocks = rows >> tq_bits;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  deinterleave_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)out, rows, d_bits, tq_bits);
  return (int)cudaGetLastError();
}

// z, out: (2^d_bits, cols); roots: 2^d_bits host felts, root j = w^j times
// the scale (w = w_D or its inverse, the scale 1 or 1/D). Returns a
// cudaError_t.
extern "C" int qzk_shard_cross_ntt(const void* z, void* out, long long cols, int d_bits,
                                   const void* roots, void* stream) {
  if (d_bits < 0 || d_bits > MAX_D_BITS || cols <= 0 || roots == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Roots r = {};
  const uint64_t* host = (const uint64_t*)roots;
  for (int j = 0; j < (1 << d_bits); ++j) r.w[j] = host[j];
  long long grid = (cols + THREADS - 1) / THREADS;
  if (grid > 8192) grid = 8192;
  cross_ntt_kernel<<<dim3((unsigned)grid, 1u << d_bits), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)z, (uint64_t*)out, cols, d_bits, r);
  return (int)cudaGetLastError();
}
