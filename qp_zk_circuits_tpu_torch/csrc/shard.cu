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
//     w_D^(+-n1 k1), times 1/D for the inverse: the length-D DFT across the
//     received slab, row k1 the slab for shard k1.
//
// Bound on the H100: bytes. Each entry reads L felts and writes L: at N =
// 2^24 over D = 4 shards, 64 MiB a shard, 0.020 ms at 3.35 TB/s. The DFT's
// least work is a radix-2 transform, (D/2) log2 D multiplies a column, far
// below the integer rate for D <= 8.
//
// The deinterleave stages a tile of consecutive input felts in shared
// memory (coalesced reads) and writes runs of L/D-contiguous rows
// (coalesced writes).
//
// The DFT moves each felt once: a thread takes a column t (two adjacent
// columns when D <= 16 and L/D is even: 16-byte loads and stores), reads its
// D inputs once (neighbouring threads on neighbouring t, so every row's read
// is coalesced), transforms them in registers by radix-2 decimation in
// frequency and writes output k1 = bitrev(k) from register k, once. (Its
// first form gave a thread one (t, k1) pair: the D rows of blocks reread
// the whole slab, (D + 1) L felts moved, and each output multiplied by
// w^0.) The kernel is a template on d_bits (0..6, D <= 64 = MAX_SHARDS), so
// the stages, the register indices and the roots' indices are fixed at
// compile time; the roots w_D^j (j < D/2) travel by value, a butterfly's
// w^0 is no multiply, and the 1/D of the inverse is one multiply an output
// in its own instance. D = 32 and 64 keep their column in registers, one
// column a thread (64 and 128 registers of data; ptxas reports no spill).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int MAX_D_BITS = 6;  // at most 64 shards (poly/ntt.py MAX_SHARDS)
constexpr int TILE_BITS = 11;  // a deinterleave block's felts: 16 KB of shared memory
constexpr int THREADS = 256;

constexpr int PAIR_D_BITS = 4;  // two columns a thread up to D = 16

struct Twiddles {
  uint64_t w[1 << (MAX_D_BITS - 1)];  // w_D^(+-j), j < D/2
  uint64_t scale;                     // 1/D for the inverse (the SCALE instances)
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

// Thread i writes W[:, C i .. C i + C - 1]: columns C i + c, c < C. Every
// loop has a trip count fixed by the template, so all unroll and x stays
// in registers.
template <int D_BITS, int C, bool SCALE>
__global__ void __launch_bounds__(THREADS)
    cross_ntt_kernel(const uint64_t* __restrict__ z, uint64_t* __restrict__ out, long long cols,
                     const __grid_constant__ Twiddles tw) {
  constexpr int D = 1 << D_BITS;
  const long long t = ((long long)blockIdx.x * THREADS + threadIdx.x) * C;
  if (t >= cols) return;
  uint64_t x[D][C];
#pragma unroll
  for (int n = 0; n < D; ++n) {
    if (C == 2) {
      const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(z + n * cols + t));
      x[n][0] = v.x;
      x[n][C - 1] = v.y;
    } else {
      x[n][0] = __ldg(z + n * cols + t);
    }
  }
  // decimation in frequency: stage st pairs x[s + j] with x[s + j + h], h =
  // D >> (st + 1), s a multiple of 2h, and multiplies the difference by
  // w_{2h}^j = w_D^(j D / 2h) = w_D^(j << st)
#pragma unroll
  for (int st = 0; st < D_BITS; ++st) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const int h = D >> (st + 1), j = i & (h - 1), lo = 2 * i - j;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint64_t a = x[lo][c], b = x[lo + h][c];
        x[lo][c] = gl::add(a, b);
        const uint64_t d = gl::sub(a, b);
        x[lo + h][c] = j ? gl::mul(d, tw.w[j << st]) : d;
      }
    }
  }
  // register k holds output bitrev(k)
#pragma unroll
  for (int k = 0; k < D; ++k) {
    int r = 0;
#pragma unroll
    for (int b = 0; b < D_BITS; ++b) r |= ((k >> b) & 1) << (D_BITS - 1 - b);
    uint64_t* dst = out + r * cols + t;
    if (SCALE) {
#pragma unroll
      for (int c = 0; c < C; ++c) x[k][c] = gl::mul(x[k][c], tw.scale);
    }
    if (C == 2) {
      *reinterpret_cast<ulonglong2*>(dst) = make_ulonglong2(x[k][0], x[k][C - 1]);
    } else {
      *dst = x[k][0];
    }
  }
}

template <int D_BITS, int C>
int launch_cross(const uint64_t* z, uint64_t* out, long long cols, const Twiddles& tw,
                 bool scale, cudaStream_t stream) {
  const long long grid = ((cols + C - 1) / C + THREADS - 1) / THREADS;
  if (grid > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  if (scale) {
    cross_ntt_kernel<D_BITS, C, true><<<(unsigned)grid, THREADS, 0, stream>>>(z, out, cols, tw);
  } else {
    cross_ntt_kernel<D_BITS, C, false><<<(unsigned)grid, THREADS, 0, stream>>>(z, out, cols, tw);
  }
  return (int)cudaGetLastError();
}

// Two columns a thread where D <= 16, the rows' length is even and both
// slabs start 16-byte aligned (then every pair is), else one.
template <int D_BITS>
int launch_cross(const uint64_t* z, uint64_t* out, long long cols, const Twiddles& tw,
                 bool scale, cudaStream_t stream) {
  if constexpr (D_BITS <= PAIR_D_BITS) {
    if (cols % 2 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(out) % 16 == 0) {
      return launch_cross<D_BITS, 2>(z, out, cols, tw, scale, stream);
    }
  }
  return launch_cross<D_BITS, 1>(z, out, cols, tw, scale, stream);
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

// z, out: (2^d_bits, cols); roots: the 2^(d_bits - 1)
// host felts w^j, j < D/2 (w = w_D or its inverse; none for D = 1); scale:
// the factor of every output (1/D for the inverse, 1 for none). Returns a
// cudaError_t.
extern "C" int qzk_shard_cross_ntt(const void* z, void* out, long long cols, int d_bits,
                                   const void* roots, unsigned long long scale, void* stream) {
  if (d_bits < 0 || d_bits > MAX_D_BITS || cols <= 0 || (d_bits > 0 && roots == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Twiddles tw = {};
  const uint64_t* host = (const uint64_t*)roots;
  for (int j = 0; j < (1 << d_bits) / 2; ++j) tw.w[j] = host[j];
  tw.scale = scale;
  const uint64_t* src = (const uint64_t*)z;
  uint64_t* dst = (uint64_t*)out;
  const bool s = scale != 1;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d_bits) {
    case 0: return launch_cross<0>(src, dst, cols, tw, s, st);
    case 1: return launch_cross<1>(src, dst, cols, tw, s, st);
    case 2: return launch_cross<2>(src, dst, cols, tw, s, st);
    case 3: return launch_cross<3>(src, dst, cols, tw, s, st);
    case 4: return launch_cross<4>(src, dst, cols, tw, s, st);
    case 5: return launch_cross<5>(src, dst, cols, tw, s, st);
    default: return launch_cross<6>(src, dst, cols, tw, s, st);
  }
}
