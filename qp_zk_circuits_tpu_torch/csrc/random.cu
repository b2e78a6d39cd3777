// Kernel G: uniform canonical Goldilocks felts by Philox4x64-10.
//
// Replaces the JAX package's plonk/prover_fused.py::_rand_felts_j, the jnp
// device function that draws a device-rng ZK proof's blinding rows and
// oracle salts (threefry bits, two draws and a select). On Hopper the
// generator is Philox4x64-10, counter-based, so each block of the stream is
// computed with no state: key (proof key, stream), counter (b, 0, 0, 0),
// and block b gives felts 2b and 2b + 1, each its first word if below p,
// else its second reduced by one conditional subtract (field/random.py
// states the mapping; its plain version equals numpy's Philox).
//
// Bound on the H100: the larger of the bytes written (8 a felt, nothing is
// read) and the FMA pipe's 64-bit products. A block needs 18 64x64->128
// products of its own: round 1 multiplies the counter, whose upper words are
// 0 and whose low word is below 2^32 here, so one half-width product (two
// 32x32->64 partials); round 2's M0 * key is the same for every block of a
// launch (computed once a thread); rounds 2-10 leave one and sixteen full
// products of four partials each: 70 IMAD.WIDE on the FMA pipe, beside the
// xors, carries and selects on the ALU pipe (chip_smoke.py's
// PHILOX_BLOCK_OPS counts them, at the pipe's full rate).
//
// The design, against each cost of the first form (one thread a block, a
// grid-stride loop, `(i / cols) * rs + (i % cols) * cs` a felt):
//   * no division a felt: a thread divides once, for its first block, then
//     steps its (column, offset) by the grid's stride with adds and one
//     compare a block (the stride's row and column steps come from the
//     host). Indices are 32-bit: the wrapper refuses a draw of 2^31 felts or
//     more (field/random.py::rand_felts_plan), and the counter then fits the
//     half-width round-1 product;
//   * each 64x64->128 product is formed once from its four 32x32->64
//     partials, shared by the low and the high word: `a * m` beside
//     `__umul64hi(a, m)` on one 64-bit counter word, which ptxas fuses
//     into IMAD.WIDE.U32 and its carry form (70 a block in the SASS,
//     `[rand 2^16]` prints the count; the first form's 64-bit counter cost
//     79 and 20 IMAD.X). Writing the partials out in C compiled worse: their
//     64-bit addends need register pairs, set up by IMAD.MOVs on the same
//     FMA pipe;
//   * ILP independent blocks a thread, their rounds interleaved, so the ten
//     dependent rounds' latency hides behind each other and not only behind
//     other warps; the grid is the SMs times the blocks that fit on one;
//   * a block's two felts go out as one 16-byte store when the wrapper's plan
//     allows (VEC: unit column stride, an even row length and row stride, a
//     16-byte aligned start: then no block straddles a row), else as two
//     8-byte stores through the row and column strides, so the trace's
//     blinding columns are still filled in place through a strided view;
//   * still one launch a draw.
// What holds it: IMAD.WIDE.U32 issues at half of IMAD's rate on the H100
// (tools/int_rate.py), so the products alone take twice the slots the bound
// counts, and the kernel is bound by the FMA pipe, not by its stores
// (PERF.md).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr uint64_t M0 = 0xD2E7470EE14C6C93ull, M1 = 0xCA5A826395121157ull;
constexpr uint32_t M0_LO = 0xE14C6C93u, M0_HI = 0xD2E7470Eu;
constexpr uint64_t W0 = 0x9E3779B97F4A7C15ull, W1 = 0xBB67AE8584CAA73Bull;
constexpr int THREADS = 256;
constexpr int ILP = 2;  // independent Philox blocks a thread interleaves
constexpr long long MAX_FELTS = 0x7fffffffll;

struct Plan {
  uint64_t* out;
  long long rs, cs;     // element strides of the (rows, cols) view
  long long step;       // offset change of a stride's step (before a wrap)
  long long wrap;       // offset change when the column wraps: rs - cols cs
  long long next_row;   // from the last column to the next row's first
  uint64_t key, stream;
  uint32_t cols, count, stride, dc;  // stride: blocks a step; dc: its columns
};

// hi:lo = a * m: one product, its four partials shared by both words.
__device__ __forceinline__ void mul128(uint64_t a, uint64_t m, uint64_t& lo, uint64_t& hi) {
  lo = a * m;
  hi = __umul64hi(a, m);
}

__device__ __forceinline__ uint64_t select(uint64_t first, uint64_t second) {
  return first < gl::P ? first : (second >= gl::P ? second - gl::P : second);
}

// Philox4x64-10 of counters (b[j], 0, 0, 0) under (key, stream), the J
// blocks' rounds interleaved; f0, f1: each block's two felts. a_lo, a_hi:
// M0 * key, round 2's product for every block.
template <int J>
__device__ __forceinline__ void philox(const uint32_t (&b)[J], uint64_t key, uint64_t stream,
                                       uint64_t a_lo, uint64_t a_hi, uint64_t (&f0)[J],
                                       uint64_t (&f1)[J]) {
  uint64_t c0[J], c1[J], c2[J], c3[J];
  // round 1: (b, 0, 0, 0), b below 2^32: one half-width product
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const uint64_t p00 = (uint64_t)b[j] * M0_LO;
    const uint64_t t = (uint64_t)b[j] * M0_HI + (p00 >> 32);
    c2[j] = (t >> 32) ^ stream;
    c3[j] = (t << 32) | (uint32_t)p00;
  }
  // round 2: c0 = key and c1 = 0 for every block
  {
    const uint64_t k0 = key + W0, x2 = a_hi ^ (stream + W1);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      uint64_t lo, hi;
      mul128(c2[j], M1, lo, hi);
      c0[j] = hi ^ k0;
      c1[j] = lo;
      c2[j] = c3[j] ^ x2;
      c3[j] = a_lo;
    }
  }
#pragma unroll
  for (int r = 2; r < 10; ++r) {
    const uint64_t k0 = key + r * W0, k1 = stream + r * W1;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      uint64_t lo0, hi0, lo1, hi1;
      mul128(c0[j], M0, lo0, hi0);
      mul128(c2[j], M1, lo1, hi1);
      c0[j] = hi1 ^ c1[j] ^ k0;
      c1[j] = lo1;
      c2[j] = hi0 ^ c3[j] ^ k1;
      c3[j] = lo0;
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    f0[j] = select(c0[j], c1[j]);
    f1[j] = select(c2[j], c3[j]);
  }
}

// Felts 2b and 2b + 1 at element offset `off` (column c) and after it.
template <bool VEC>
__device__ __forceinline__ void store(const Plan& p, long long off, uint32_t c, uint32_t b,
                                      uint64_t f0, uint64_t f1) {
  if (VEC) {
    *reinterpret_cast<ulonglong2*>(p.out + off) = make_ulonglong2(f0, f1);
  } else {
    p.out[off] = f0;
    if (2 * b + 1 < p.count) p.out[off + (c + 1 < p.cols ? p.cs : p.next_row)] = f1;
  }
}

// The position of the block `stride` further on.
__device__ __forceinline__ void advance(const Plan& p, long long& off, uint32_t& c) {
  c += p.dc;
  off += p.step;
  if (c >= p.cols) {
    c -= p.cols;
    off += p.wrap;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) rand_felts_kernel(const __grid_constant__ Plan p) {
  const uint32_t blocks = (p.count + 1) >> 1;
  uint32_t b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= blocks) return;
  const uint64_t a_lo = M0 * p.key, a_hi = __umul64hi(M0, p.key);
  // the thread's one division: the first block's row and column
  uint32_t c = (2 * b) % p.cols;
  long long off = (long long)((2 * b) / p.cols) * p.rs + (long long)c * p.cs;
  for (; b + (ILP - 1) * p.stride < blocks; b += ILP * p.stride) {
    uint32_t ctr[ILP];
    uint64_t f0[ILP], f1[ILP];
#pragma unroll
    for (int j = 0; j < ILP; ++j) ctr[j] = b + j * p.stride;
    philox<ILP>(ctr, p.key, p.stream, a_lo, a_hi, f0, f1);
#pragma unroll
    for (int j = 0; j < ILP; ++j) {
      store<VEC>(p, off, c, ctr[j], f0[j], f1[j]);
      advance(p, off, c);
    }
  }
  for (; b < blocks; b += p.stride) {
    const uint32_t ctr[1] = {b};
    uint64_t f0[1], f1[1];
    philox<1>(ctr, p.key, p.stream, a_lo, a_hi, f0, f1);
    store<VEC>(p, off, c, b, f0[0], f1[0]);
    advance(p, off, c);
  }
}

}  // namespace

// out: rows x cols felts at out[r * rs + c * cs] (element strides), felt
// i = r * cols + c, fewer than 2^31 in all; key, stream: the Philox key;
// vec: 16-byte stores (cs = 1, cols even, rs even or one row, out 16-byte
// aligned; field/random.py::rand_felts_plan decides). Returns a
// cudaError_t.
extern "C" int qzk_rand_felts(void* out, long long rows, long long cols, long long rs,
                              long long cs, unsigned long long key, unsigned long long stream,
                              int vec, void* stream_ptr) {
  if (rows <= 0 || cols <= 0) return 0;
  if (out == nullptr || rows > MAX_FELTS || cols > MAX_FELTS || rows * cols > MAX_FELTS) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec && (cs != 1 || cols % 2 != 0 || (rows > 1 && rs % 2 != 0) ||
              reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long count = rows * cols, blocks = (count + 1) / 2;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, vec ? rand_felts_kernel<true> : rand_felts_kernel<false>, THREADS, 0);
  }
  if (err != cudaSuccess) return (int)err;
  long long grid = (blocks + THREADS - 1) / THREADS;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > resident) grid = resident;
  Plan p;
  p.out = (uint64_t*)out;
  p.rs = rs;
  p.cs = cs;
  p.key = key;
  p.stream = stream;
  p.cols = (uint32_t)cols;
  p.count = (uint32_t)count;
  p.stride = (uint32_t)(grid * THREADS);
  const long long step_felts = 2ll * p.stride;
  p.dc = (uint32_t)(step_felts % cols);
  p.step = (step_felts / cols) * rs + (long long)p.dc * cs;
  p.wrap = rs - cols * cs;
  p.next_row = rs - (cols - 1) * cs;
  if (vec) {
    rand_felts_kernel<true><<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream_ptr>>>(p);
  } else {
    rand_felts_kernel<false><<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream_ptr>>>(p);
  }
  return (int)cudaGetLastError();
}
