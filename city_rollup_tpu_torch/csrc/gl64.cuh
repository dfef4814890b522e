// Goldilocks field (p = 2^64 - 2^32 + 1) on native uint64_t, for every
// kernel of the port. The reference (city_rollup_tpu/core/gl64.py) carries a
// value as two uint32 limbs because the TPU has no 64-bit integer datapath;
// the GPU has one, so a value is one uint64_t and a product is four
// 32x32 -> 64 multiplies, reduced as the reference's _reduce128 does:
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).
//
// Two kinds of step. The canonical ones (gl_add, gl_sub, gl_mul, gl_pow)
// take values < p and return a value < p. The lazy ones (*_lazy) take any
// u64 (gl_add_lazy and gl_sub_lazy: a second operand < p) and return some
// u64 congruent mod p, which may be >= p: the Poseidon core carries such
// values between rounds and the NTT kernels between passes, and each
// canonicalises once, at the end, as the reference's TPU kernel does.
//
// The lazy steps are PTX carry chains on 32-bit words: the Poseidon core's
// time follows its instruction count, and a carry flag replaces the compare
// and select that C code needs to detect a wrap. Each chain keeps an exact count k of the 2^64 wraps and adds
// k * EPS (2^64 = EPS mod p) at the end. Values in [p, 2^64) are rare on
// random data, so each step is modelled line for line in python ints and run
// on edge values by tests/test_torch_gl64_lazy.py; keep the two in step.
#pragma once

#include <cstdint>

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL  // 2^64 mod p

__device__ __forceinline__ uint32_t gl_lo(uint64_t a) { return (uint32_t)a; }
__device__ __forceinline__ uint32_t gl_hi(uint64_t a) {
  return (uint32_t)(a >> 32);
}

// Any u64 is < 2p, so one conditional subtract makes it canonical.
__device__ __forceinline__ uint64_t gl_canonicalize(uint64_t a) {
  return a >= GL_P ? a - GL_P : a;
}

// a: any u64; c < p. A carry k is worth k * EPS = k * 2^32 - k; the wrapped
// sum is then < c < p, so adding EPS does not carry again.
__device__ __forceinline__ uint64_t gl_add_lazy(uint64_t a, uint64_t c) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 s0, s1, k;\n\t"
      "add.cc.u32 s0, %1, %3;\n\t"
      "addc.cc.u32 s1, %2, %4;\n\t"
      "addc.u32 k, 0, 0;\n\t"
      "sub.cc.u32 s0, s0, k;\n\t"
      "subc.u32 s1, s1, 0;\n\t"
      "add.u32 s1, s1, k;\n\t"
      "mov.b64 %0, {s0, s1};\n\t"
      "}"
      : "=l"(r)
      : "r"(gl_lo(a)), "r"(gl_hi(a)), "r"(gl_lo(c)), "r"(gl_hi(c)));
  return r;
}

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  return gl_canonicalize(gl_add_lazy(a, b));
}

// a - c for any u64 a and c < p, as some u64. A borrow means a < c, so
// d = a - c + 2^64 >= 2^64 - p + 1 = EPS + 1, and d - EPS (2^64 = EPS mod p
// taken back) does not wrap; k = -borrow is EPS or 0 as a 32-bit word.
__device__ __forceinline__ uint64_t gl_sub_lazy(uint64_t a, uint64_t c) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 d0, d1, k;\n\t"
      "sub.cc.u32 d0, %1, %3;\n\t"
      "subc.cc.u32 d1, %2, %4;\n\t"
      "subc.u32 k, 0, 0;\n\t"
      "sub.cc.u32 d0, d0, k;\n\t"
      "subc.u32 d1, d1, 0;\n\t"
      "mov.b64 %0, {d0, d1};\n\t"
      "}"
      : "=l"(r)
      : "r"(gl_lo(a)), "r"(gl_hi(a)), "r"(gl_lo(c)), "r"(gl_hi(c)));
  return r;
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  // a borrow took 2^64 too many: adding p back is subtracting EPS
  if (a < b) d -= GL_EPS;
  return d;
}

// a * b = r0 + r1 2^32 + r2 2^64 + r3 2^96, for any u64 a, b: four 32x32
// products, the two cross products added with one carry chain each (the
// full product is < 2^128, so r3 never carries out).
__device__ __forceinline__ void gl_mul_words(uint64_t a, uint64_t b,
                                             uint32_t& r0, uint32_t& r1,
                                             uint32_t& r2, uint32_t& r3) {
  asm("{\n\t"
      ".reg .u32 m, h;\n\t"
      ".reg .u64 t;\n\t"
      "mul.wide.u32 t, %4, %6;\n\t"
      "mov.b64 {%0, %1}, t;\n\t"
      "mul.wide.u32 t, %5, %7;\n\t"
      "mov.b64 {%2, %3}, t;\n\t"
      "mul.wide.u32 t, %4, %7;\n\t"
      "mov.b64 {m, h}, t;\n\t"
      "add.cc.u32 %1, %1, m;\n\t"
      "addc.cc.u32 %2, %2, h;\n\t"
      "addc.u32 %3, %3, 0;\n\t"
      "mul.wide.u32 t, %5, %6;\n\t"
      "mov.b64 {m, h}, t;\n\t"
      "add.cc.u32 %1, %1, m;\n\t"
      "addc.cc.u32 %2, %2, h;\n\t"
      "addc.u32 %3, %3, 0;\n\t"
      "}"
      : "=&r"(r0), "=&r"(r1), "=&r"(r2), "=&r"(r3)
      : "r"(gl_lo(a)), "r"(gl_hi(a)), "r"(gl_lo(b)), "r"(gl_hi(b)));
}

// (r0 + r1 2^32 + r2 2^64 + r3 2^96) mod p, as some u64. With 2^64 =
// 2^32 - 1 and 2^96 = -1 (mod p): V = (r0 + r1 2^32) - (r2 + r3) + r2 2^32,
// so -2^32 < V < 2^65. W = V mod 2^64 and k = (V - W) / 2^64 in
// {-1, 0, 1}; W + k EPS does not wrap (k = 1 means W < 2^64 - 2^33, k = -1
// means W > 2^64 - 2^32), and k EPS as 64 bits is (-k) + (k >> 31) 2^32.
__device__ __forceinline__ uint64_t gl_reduce_words(uint32_t r0, uint32_t r1,
                                                    uint32_t r2,
                                                    uint32_t r3) {
  uint64_t out;
  asm("{\n\t"
      ".reg .u32 w0, w1, s, sh, k, m, h;\n\t"
      "add.cc.u32 s, %3, %4;\n\t"
      "addc.u32 sh, 0, 0;\n\t"
      "sub.cc.u32 w0, %1, s;\n\t"
      "subc.cc.u32 w1, %2, sh;\n\t"
      "subc.u32 k, 0, 0;\n\t"
      "add.cc.u32 w1, w1, %3;\n\t"
      "addc.u32 k, k, 0;\n\t"
      "neg.s32 m, k;\n\t"
      "shr.s32 h, k, 31;\n\t"
      "add.cc.u32 w0, w0, m;\n\t"
      "addc.u32 w1, w1, h;\n\t"
      "mov.b64 %0, {w0, w1};\n\t"
      "}"
      : "=l"(out)
      : "r"(r0), "r"(r1), "r"(r2), "r"(r3));
  return out;
}

// (lo + hi 2^32) mod p, as some u64, for lo, hi < 2^42 (the MDS's split
// accumulators): with words lo = a0 + a1 2^32, hi = b0 + b1 2^32,
// V = a0 - b1 + (a1 + b0 + b1) 2^32 (2^64 = 2^32 - 1), -2^10 < V < 2^65.
__device__ __forceinline__ uint64_t gl_reduce_split_lazy(uint64_t lo,
                                                         uint64_t hi) {
  uint64_t out;
  asm("{\n\t"
      ".reg .u32 w0, w1, s, sh, k, m, h;\n\t"
      "add.cc.u32 s, %2, %3;\n\t"
      "addc.u32 sh, 0, 0;\n\t"
      "add.cc.u32 s, s, %4;\n\t"
      "addc.u32 sh, sh, 0;\n\t"
      "sub.cc.u32 w0, %1, %4;\n\t"
      "subc.cc.u32 w1, s, 0;\n\t"
      "subc.u32 k, sh, 0;\n\t"
      "neg.s32 m, k;\n\t"
      "shr.s32 h, k, 31;\n\t"
      "add.cc.u32 w0, w0, m;\n\t"
      "addc.u32 w1, w1, h;\n\t"
      "mov.b64 %0, {w0, w1};\n\t"
      "}"
      : "=l"(out)
      : "r"(gl_lo(lo)), "r"(gl_hi(lo)), "r"(gl_lo(hi)), "r"(gl_hi(hi)));
  return out;
}

__device__ __forceinline__ uint64_t gl_mul_lazy(uint64_t a, uint64_t b) {
  uint32_t r0, r1, r2, r3;
  gl_mul_words(a, b, r0, r1, r2, r3);
  return gl_reduce_words(r0, r1, r2, r3);
}

// x * 2^e for any u64 x and 0 < e < 64, as some u64: the 128-bit product
// is x's words shifted, so one reduction replaces the four products of
// gl_mul_words. The NTT's radix-16 twiddles are such powers (w_16 = 2^156
// and 2^96 = -1 mod p); e must be a constant for the shifts to fold.
__device__ __forceinline__ uint64_t gl_mul_pow2_lazy(uint64_t x, int e) {
  const uint64_t lo = x << e, hi = x >> (64 - e);
  return gl_reduce_words(gl_lo(lo), gl_hi(lo), gl_lo(hi), gl_hi(hi));
}

// 2^e mod p for 0 <= e < 96, canonical: 2^e itself below 2^64, and
// 2^(e-64) (2^32 - 1) = 2^(e-32) - 2^(e-64) < 2^63 above (2^64 = EPS).
__host__ __device__ constexpr uint64_t gl_pow2_const(int e) {
  return e < 64 ? 1ULL << e : (1ULL << (e - 32)) - (1ULL << (e - 64));
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_canonicalize(gl_mul_lazy(a, b));
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
