// Goldilocks field (p = 2^64 - 2^32 + 1) on native uint64_t, for every
// kernel of the port. The reference (city_rollup_tpu/core/gl64.py) carries a
// value as two uint32 limbs because the TPU has no 64-bit integer datapath;
// the GPU has one, so a value is one uint64_t and a product is one
// 64x64 -> 128 multiply (a * b and __umul64hi), reduced as the reference's
// _reduce128 does: 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).
//
// Every function takes canonical inputs (< p) and returns a canonical value,
// except gl_reduce96 and gl_canonicalize, which accept any u64.
#pragma once

#include <cstdint>

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL  // 2^64 mod p

__device__ __forceinline__ uint64_t gl_canonicalize(uint64_t a) {
  return a >= GL_P ? a - GL_P : a;
}

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  // a carry out is worth 2^64 = EPS; the sum then is < p - EPS, no re-carry
  if (s < a) s += GL_EPS;
  return gl_canonicalize(s);
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  // a borrow took 2^64 too many: adding p back is subtracting EPS
  if (a < b) d -= GL_EPS;
  return d;
}

// (lo + hi * 2^64) mod p for any 128-bit value.
__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & GL_EPS;
  uint64_t t = lo - hi_hi;  // - hi_hi * 2^96 = + hi_hi
  if (lo < hi_hi) t -= GL_EPS;
  uint64_t m = hi_lo * GL_EPS;  // hi_lo * 2^64, < 2^64
  uint64_t r = t + m;
  if (r < m) r += GL_EPS;
  return gl_canonicalize(r);
}

// (lo + hi * 2^64) mod p for hi < 2^32 (the MDS accumulator).
__device__ __forceinline__ uint64_t gl_reduce96(uint64_t lo, uint64_t hi) {
  uint64_t m = hi * GL_EPS;
  uint64_t r = lo + m;
  if (r < m) r += GL_EPS;
  return gl_canonicalize(r);
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t gl_sqr(uint64_t a) { return gl_mul(a, a); }

__device__ __forceinline__ uint64_t gl_pow(uint64_t base, uint64_t e) {
  uint64_t r = 1;
  while (e) {
    if (e & 1) r = gl_mul(r, base);
    base = gl_sqr(base);
    e >>= 1;
  }
  return r;
}
