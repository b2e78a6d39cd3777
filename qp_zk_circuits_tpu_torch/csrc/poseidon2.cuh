// Poseidon2 (Goldilocks, width 12, x^7) building blocks shared by kernel 2
// (poseidon2.cu, the permutation) and kernel A (quotient.cu, the Poseidon2
// gate's constraints). Each translation unit keeps its own __constant__ copy
// of the round constants and the internal diagonal, uploaded from the one
// host generator (hash/poseidon2.py::_constants); these functions take the
// diagonal as an argument and hold no table themselves.
//
// Linear layers accumulate 128-bit sums of small multiples and reduce once;
// every function is exact, so it equals the host's op-by-op version bit for
// bit.
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

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  uint64_t x2 = gl::mul(x, x);
  uint64_t x4 = gl::mul(x2, x2);
  return gl::mul(gl::mul(x4, x2), x);
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

}  // namespace p2
