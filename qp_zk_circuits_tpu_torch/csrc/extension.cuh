// The quadratic extension F_p[X] / (X^2 - W), W = 7, on native 64-bit lanes.
//
// Counterpart of field/extension.py's device ops (j_mul, j_scalar_mul,
// j_inv) and of the JAX package's GF2 algebra: an element is (c0, c1) =
// c0 + c1 X, every component canonical. The field is exact, so these give
// the same bits as the host oracle field/extension.py.
#pragma once

#include "goldilocks.cuh"

namespace ext {

constexpr uint64_t W = 7;  // X^2 = W, field/extension.py:22

struct E {
  uint64_t c0, c1;
};

__device__ __forceinline__ E add(E a, E b) { return {gl::add(a.c0, b.c0), gl::add(a.c1, b.c1)}; }

__device__ __forceinline__ E sub(E a, E b) { return {gl::sub(a.c0, b.c0), gl::sub(a.c1, b.c1)}; }

// (a0 + a1 X)(b0 + b1 X) = (a0 b0 + W a1 b1) + (a0 b1 + a1 b0) X
__device__ __forceinline__ E mul(E a, E b) {
  return {gl::add(gl::mul(a.c0, b.c0), gl::mul(W, gl::mul(a.c1, b.c1))),
          gl::add(gl::mul(a.c0, b.c1), gl::mul(a.c1, b.c0))};
}

// extension times base-field scalar
__device__ __forceinline__ E scale(E a, uint64_t s) { return {gl::mul(a.c0, s), gl::mul(a.c1, s)}; }

// a^e by square and multiply
__device__ __forceinline__ E pow(E a, unsigned long long e) {
  E r = {1, 0};
  while (e) {
    if (e & 1) r = mul(r, a);
    e >>= 1;
    if (e) a = mul(a, a);
  }
  return r;
}

// (a0 + a1 X)^-1 = (a0 - a1 X) / (a0^2 - W a1^2), one Fermat power of the
// norm; inv(0) = 0 as in the reference.
__device__ __forceinline__ E inv(E a) {
  const uint64_t norm = gl::sub(gl::mul(a.c0, a.c0), gl::mul(W, gl::mul(a.c1, a.c1)));
  const uint64_t ninv = gl::inv(norm);
  return {gl::mul(a.c0, ninv), gl::mul(gl::sub(0, a.c1), ninv)};
}

}  // namespace ext
