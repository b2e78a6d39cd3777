// Poseidon2 (Goldilocks, width 12, x^7) building blocks shared by kernel 2
// (poseidon2.cu, the permutation) and kernel A (quotient.cu, the Poseidon2
// gate's constraints). Each translation unit keeps its own __constant__ copy
// of the round constants and the internal diagonal, uploaded from the one
// host generator (hash/poseidon2.py::_constants); these functions take the
// diagonal as an argument and hold no table themselves.
//
// Linear layers accumulate 128-bit sums of small multiples and reduce once;
// every function is exact, so it equals the host's op-by-op version bit for
// bit. The lane-split layers (a state over a quad of threads) regroup the
// same sums, so they give the same bits too; kernel 2 uses them.
#pragma once

#include <stdint.h>

#include "goldilocks.cuh"

namespace p2 {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int DIGEST = 4;
constexpr int ROUNDS_F = 8;
constexpr int ROUNDS_P = 22;

struct U128 {
  uint64_t lo, hi;
};

__device__ __forceinline__ void mac(U128& acc, uint64_t x, uint64_t c) {
  uint64_t lo = x * c;
  uint64_t hi = __umul64hi(x, c);
  acc.lo += lo;
  acc.hi += hi + (acc.lo < lo ? 1 : 0);
}

__device__ __forceinline__ U128 add128(U128 a, U128 b) {
  U128 r;
  r.lo = a.lo + b.lo;
  r.hi = a.hi + b.hi + (r.lo < a.lo ? 1 : 0);
  return r;
}

// x^7 in four multiplies three deep: x^3 and x^4 both wait only on x^2.
__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl::mul(x, x);
  return gl::mul(gl::mul(x2, x), gl::mul(x2, x2));
}

// M_E = circ(2*M4, M4, M4): per-group M4, then add the sum over groups.
__device__ __forceinline__ void external_linear(uint64_t* x) {
  const uint64_t m4[4][4] = {{5, 7, 1, 3}, {4, 6, 1, 1}, {1, 3, 5, 7}, {1, 1, 4, 6}};
  U128 y[3][4];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      U128 acc = {0, 0};
#pragma unroll
      for (int j = 0; j < 4; ++j) mac(acc, x[4 * g + j], m4[i][j]);
      y[g][i] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    U128 s = add128(add128(y[0][i], y[1][i]), y[2][i]);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      U128 v = add128(y[g][i], s);
      x[4 * g + i] = gl::reduce128(v.lo, v.hi);
    }
  }
}

// M_I(x)_i = diag_i * x_i + sum_j x_j.
__device__ __forceinline__ void internal_linear(uint64_t* x, const uint64_t* diag) {
  U128 tot = {0, 0};
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) mac(tot, x[i], 1);
  uint64_t t = gl::reduce128(tot.lo, tot.hi);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    U128 v = {0, 0};
    mac(v, x[i], diag[i]);
    mac(v, t, 1);
    x[i] = gl::reduce128(v.lo, v.hi);
  }
}

// ---------------------------------------------------------------------------
// Lane-split form: the four threads of an aligned quad of a warp hold one
// state, thread j (= lane % 4) lanes j, 4 + j and 8 + j in x[0], x[1], x[2]:
// one lane of each M4 group. Every thread of the warp must make the same
// calls (the shuffles name the full warp).
constexpr int SPLIT = 4;
constexpr int SPLIT_SLOTS = WIDTH / SPLIT;

__device__ __forceinline__ uint64_t quad_shfl(uint64_t v, int src) {
  return (uint64_t)__shfl_sync(0xffffffffu, (unsigned long long)v, src, SPLIT);
}

__device__ __forceinline__ uint64_t quad_shfl_xor(uint64_t v, int mask) {
  return (uint64_t)__shfl_xor_sync(0xffffffffu, (unsigned long long)v, mask, SPLIT);
}

// Row j of M4 packed a nibble a coefficient: M4[j][k] = (M4_ROWS >> (16 j + 4 k)) & 15.
constexpr uint64_t M4_ROWS = 0x6411ull << 48 | 0x7531ull << 32 | 0x1164ull << 16 | 0x3175ull;

// M_E on a split state: thread j gathers its group's other three lanes from
// the quad, lane (j + k) % 4 by the k-th shuffle, and forms output lane j of
// each group; the sum over the three groups then stays in the thread. The
// same 128-bit sums as external_linear.
__device__ __forceinline__ void external_linear_split(uint64_t* x, int j) {
  const uint64_t row = M4_ROWS >> (16 * j);
  U128 y[SPLIT_SLOTS];
#pragma unroll
  for (int g = 0; g < SPLIT_SLOTS; ++g) {
    U128 acc = {0, 0};
    mac(acc, x[g], (row >> (4 * j)) & 15);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const int src = (j + k) & 3;
      mac(acc, quad_shfl(x[g], src), (row >> (4 * src)) & 15);
    }
    y[g] = acc;
  }
  const U128 s = add128(add128(y[0], y[1]), y[2]);
#pragma unroll
  for (int g = 0; g < SPLIT_SLOTS; ++g) {
    U128 v = add128(y[g], s);
    x[g] = gl::reduce128(v.lo, v.hi);
  }
}

// M_I on a split state: each thread's 3-lane sum, reduced, then two xor
// shuffles add the quad's partial sums (exact mod p, so the same total).
// d holds diag[j], diag[4 + j], diag[8 + j].
__device__ __forceinline__ void internal_linear_split(uint64_t* x, const uint64_t* d) {
  U128 part = {0, 0};
#pragma unroll
  for (int s = 0; s < SPLIT_SLOTS; ++s) mac(part, x[s], 1);
  uint64_t t = gl::reduce128(part.lo, part.hi);
  t = gl::add(t, quad_shfl_xor(t, 1));
  t = gl::add(t, quad_shfl_xor(t, 2));
#pragma unroll
  for (int s = 0; s < SPLIT_SLOTS; ++s) {
    U128 v = {0, 0};
    mac(v, x[s], d[s]);
    mac(v, t, 1);
    x[s] = gl::reduce128(v.lo, v.hi);
  }
}

}  // namespace p2
