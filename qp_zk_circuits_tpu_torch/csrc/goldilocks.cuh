// Goldilocks field arithmetic on native 64-bit lanes, p = 2^64 - 2^32 + 1.
//
// Counterpart of the JAX package's u32-pair limb algebra
// (qp_zk_circuits_tpu/field/goldilocks.py, ops/field_kernels.py::_mul_block):
// the TPU had no 64-bit integer path, Hopper does, so a felt is one uint64_t
// and the 128-bit product comes from a*b and __umul64hi. Every function takes
// and returns canonical values (in [0, p)), and follows the host oracle
// field/gf_np.py step for step, so results are bit-identical to it.
#pragma once

#include <stdint.h>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ULL;
constexpr uint64_t EPS = 0xFFFFFFFFULL;  // 2^64 mod p

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  s += (s < a) ? EPS : 0;  // carry out of 2^64; cannot re-carry for a, b < p
  return (s >= P) ? s - P : s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  return (a < b) ? d - EPS : d;  // borrowed 2^64: a - b + p
}

// (lo + hi * 2^64) mod p, canonical, with 2^64 = 2^32 - 1 and 2^96 = -1.
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;
  uint64_t t1 = hi_lo * EPS;
  uint64_t t2 = t0 + t1;
  if (t2 < t0) t2 += EPS;
  return (t2 >= P) ? t2 - P : t2;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

// (lo, hi, top) += a * b: a sum of 128-bit products in 192 bits, reduced
// once by reduce192 (top counts the carries out of 2^128).
__device__ __forceinline__ void mac(uint64_t& lo, uint64_t& hi, unsigned& top, uint64_t a,
                                    uint64_t b) {
  const uint64_t pl = a * b;
  const uint64_t ph = __umul64hi(a, b);
  lo += pl;
  const uint64_t t = ph + (lo < pl);  // ph < 2^64 - 1: no wrap
  hi += t;
  top += hi < t;
}

// (lo + hi 2^64 + top 2^128) mod p, canonical, top < 2^32 - 1: 2^128 = -2^32
// mod p, and reduce128 takes any 128-bit value.
__device__ __forceinline__ uint64_t reduce192(uint64_t lo, uint64_t hi, unsigned top) {
  return sub(reduce128(lo, hi), (uint64_t)top << 32);
}

// a^e for a small exponent (kernel A's alpha powers), square and multiply.
__device__ __forceinline__ uint64_t pow(uint64_t a, unsigned e) {
  uint64_t r = 1;
  while (e) {
    if (e & 1) r = mul(r, a);
    e >>= 1;
    if (e) a = mul(a, a);
  }
  return r;
}

// x^(2^k): k squarings.
__device__ __forceinline__ uint64_t sqr_n(uint64_t x, int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) x = mul(x, x);
  return x;
}

// a^(p-2), the inverse of a nonzero a, and inv(0) = 0 as
// field/goldilocks.py::inv gives. p - 2 = (2^32 - 2) * 2^32 + (2^32 - 1), so
// with t_k = a^(2^k - 1) built by t_{j+k} = t_j^(2^k) * t_k: 63 squarings
// and 9 multiplies in one dependent chain, where square and multiply takes
// 127.
__device__ __forceinline__ uint64_t inv(uint64_t a) {
  const uint64_t t2 = mul(mul(a, a), a);
  const uint64_t t3 = mul(mul(t2, t2), a);
  const uint64_t t6 = mul(sqr_n(t3, 3), t3);
  const uint64_t t12 = mul(sqr_n(t6, 6), t6);
  const uint64_t t24 = mul(sqr_n(t12, 12), t12);
  const uint64_t t30 = mul(sqr_n(t24, 6), t6);
  const uint64_t t31 = mul(mul(t30, t30), a);
  const uint64_t hi = mul(t31, t31);  // a^(2^32 - 2)
  return mul(sqr_n(hi, 32), mul(hi, a));
}

}  // namespace gl
