// The width-12 Poseidon permutation over Goldilocks, one state per thread in
// 12 registers: 4 full rounds, 22 partial rounds, 4 full rounds. Same
// function and round schedule as the reference
// (city_rollup_tpu/core/pallas_poseidon.py _permute_t, poseidon_host.permute):
// each round adds its constants, applies x^7 (every lane, or lane 0 in a
// partial round), then the circ+diag MDS.
//
// Issue sets the pace: on this card a chain of one instruction kind issues
// about half a warp instruction a clock per scheduler, kinds on different
// pipes together up to one, and an all-integer core ran at half the
// dispatch peak while the FP64 pipe stayed idle (kernel_report.py
// --pipes). So the S-boxes' 64x64 products stay integer, with few
// instructions (PTX carry chains, gl64.cuh), and the MDS moves to the FP64
// pipe. The reference does its MDS on the TPU's MXU as a bf16
// (96,96)x(96,B) limb matmul; here it is 288 DFMAs a round on the two
// 32-bit halves of each lane, exact because every product (<= 49 (2^32 - 1))
// and every partial sum stays an integer below 2^53.
// Each row's sum starts at 2^52 + one word of the next round's constant, so
// the next round's constant add is free and the sum's bits below bit 52 are
// the integer sum (< 2^42); the two halves' sums are joined and reduced once
// on the integer pipe. Only round 0 adds its constants itself.
//
// Every value between rounds is some u64, not necessarily < p (the lazy
// steps of gl64.cuh); the permutation canonicalises once, after round 30.
// tests/test_torch_gl64_lazy.py models this core step for step in python
// ints, with the bounds that make each DFMA exact asserted.
#pragma once

#include <cstdint>

#include "gl64.cuh"

#define POS_WIDTH 12
#define POS_RATE 8
#define POS_HALF_FULL 4
#define POS_PARTIAL 22
#define POS_ROUNDS 30

// Copied into __constant__ memory at load time (city_poseidon_init, from
// poseidon_params.py in cuda_poseidon._TABLES_HOST), in this order: every
// thread of a warp reads the same constant at the same time, which the
// constant cache broadcasts.
struct PosTables {
  uint64_t round_constants[POS_ROUNDS][POS_WIDTH];
  // 2^52 + each 32-bit word (low, high) of round r's constants; row
  // POS_ROUNDS is 2^52 alone (no round follows the last)
  double mds_start[POS_ROUNDS + 1][POS_WIDTH][2];
};

__constant__ PosTables kPos;

// MDS row r: circ rotated by r, plus diag[r] on the main diagonal. Local
// constexpr tables: every index is a constant after unrolling, so each
// entry folds into the multiply as an immediate.
__device__ __forceinline__ uint32_t pos_mds_circ(int i) {
  constexpr uint32_t v[POS_WIDTH] = {17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20};
  return v[i];
}

__device__ __forceinline__ uint32_t pos_mds_diag(int i) {
  constexpr uint32_t v[POS_WIDTH] = {8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  return v[i];
}

__device__ __forceinline__ uint64_t pos_sbox(uint64_t x) {
  const uint64_t x2 = gl_mul_lazy(x, x);
  const uint64_t x3 = gl_mul_lazy(x2, x);
  const uint64_t x6 = gl_mul_lazy(x3, x3);
  return gl_mul_lazy(x6, x);
}

// A 32-bit word as a double, exactly: 2^52 + h has h as its mantissa.
__device__ __forceinline__ double pos_word_f64(uint32_t h) {
  return __hiloint2double(0x43300000, (int)h) - 4503599627370496.0;
}

// s <- MDS s + the constants of round r_next (row POS_ROUNDS: none).
__device__ __forceinline__ void pos_mds(uint64_t s[POS_WIDTH], int r_next) {
  double lo[POS_WIDTH], hi[POS_WIDTH];
#pragma unroll
  for (int i = 0; i < POS_WIDTH; ++i) {
    lo[i] = pos_word_f64(gl_lo(s[i]));
    hi[i] = pos_word_f64(gl_hi(s[i]));
  }
  constexpr uint64_t kMantissa = (1ULL << 52) - 1;
#pragma unroll
  for (int r = 0; r < POS_WIDTH; ++r) {
    double acc_lo = kPos.mds_start[r_next][r][0];
    double acc_hi = kPos.mds_start[r_next][r][1];
#pragma unroll
    for (int i = 0; i < POS_WIDTH; ++i) {
      const double c =
          (double)(pos_mds_circ(i) + (i == 0 ? pos_mds_diag(r) : 0u));
      acc_lo = fma(c, lo[(i + r) % POS_WIDTH], acc_lo);
      acc_hi = fma(c, hi[(i + r) % POS_WIDTH], acc_hi);
    }
    s[r] = gl_reduce_split_lazy(
        (uint64_t)__double_as_longlong(acc_lo) & kMantissa,
        (uint64_t)__double_as_longlong(acc_hi) & kMantissa);
  }
}

// Round r (its constants were added by the round before).
__device__ __forceinline__ void pos_full_round(uint64_t s[POS_WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < POS_WIDTH; ++i) s[i] = pos_sbox(s[i]);
  pos_mds(s, r + 1);
}

__device__ __forceinline__ void pos_partial_round(uint64_t s[POS_WIDTH],
                                                  int r) {
  s[0] = pos_sbox(s[0]);
  pos_mds(s, r + 1);
}

__device__ __forceinline__ void pos_permute(uint64_t s[POS_WIDTH]) {
#pragma unroll
  for (int i = 0; i < POS_WIDTH; ++i)
    s[i] = gl_add_lazy(s[i], kPos.round_constants[0][i]);
#pragma unroll 1
  for (int r = 0; r < POS_HALF_FULL; ++r) pos_full_round(s, r);
#pragma unroll 1
  for (int r = POS_HALF_FULL; r < POS_HALF_FULL + POS_PARTIAL; ++r)
    pos_partial_round(s, r);
#pragma unroll 1
  for (int r = POS_HALF_FULL + POS_PARTIAL; r < POS_ROUNDS; ++r)
    pos_full_round(s, r);
#pragma unroll
  for (int i = 0; i < POS_WIDTH; ++i) s[i] = gl_canonicalize(s[i]);
}
