// The width-12 Poseidon permutation over Goldilocks, one state per thread in
// 12 registers: 4 full rounds, 22 partial rounds, 4 full rounds; each round
// adds its constants, applies x^7 (to all lanes, or to lane 0 in a partial
// round), then the circ+diag MDS. Same schedule as the reference
// (city_rollup_tpu/core/pallas_poseidon.py _permute_t, poseidon_host.permute).
//
// The reference does the MDS on the TPU's MXU as a bf16 (96,96)x(96,B) limb
// matmul. Here it is 144 small-constant multiply-adds per round into a
// split accumulator: each lane's low and high 32-bit halves are summed
// apart (each sum < 2^41), joined into one < 2^73 value, and reduced once.
// Every value between rounds is canonical.
#pragma once

#include <cstdint>

#include "gl64.cuh"

#define POS_WIDTH 12
#define POS_RATE 8
#define POS_HALF_FULL 4
#define POS_PARTIAL 22
#define POS_ROUNDS 30

// Copied into __constant__ memory at load time from poseidon_params.py
// (city_poseidon_init): every thread of a warp reads the same round
// constant at the same time, which the constant cache broadcasts.
__constant__ uint64_t kRoundConstants[POS_ROUNDS * POS_WIDTH];

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
  const uint64_t x2 = gl_sqr(x);
  const uint64_t x3 = gl_mul(x2, x);
  const uint64_t x6 = gl_sqr(x3);
  return gl_mul(x6, x);
}

__device__ __forceinline__ void pos_mds(uint64_t s[POS_WIDTH]) {
  uint64_t out[POS_WIDTH];
#pragma unroll
  for (int r = 0; r < POS_WIDTH; ++r) {
    uint64_t acc_lo = 0, acc_hi = 0;
#pragma unroll
    for (int i = 0; i < POS_WIDTH; ++i) {
      const uint64_t c = pos_mds_circ(i) + (i == 0 ? pos_mds_diag(r) : 0u);
      const uint64_t v = s[(i + r) % POS_WIDTH];
      acc_lo += c * (v & 0xFFFFFFFFULL);
      acc_hi += c * (v >> 32);
    }
    // value = acc_lo + acc_hi * 2^32 < 2^73
    const uint64_t lo = acc_lo + (acc_hi << 32);
    const uint64_t hi = (acc_hi >> 32) + (lo < acc_lo ? 1 : 0);
    out[r] = gl_reduce96(lo, hi);
  }
#pragma unroll
  for (int r = 0; r < POS_WIDTH; ++r) s[r] = out[r];
}

__device__ __forceinline__ void pos_full_round(uint64_t s[POS_WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < POS_WIDTH; ++i)
    s[i] = pos_sbox(gl_add(s[i], kRoundConstants[r * POS_WIDTH + i]));
  pos_mds(s);
}

__device__ __forceinline__ void pos_partial_round(uint64_t s[POS_WIDTH],
                                                  int r) {
#pragma unroll
  for (int i = 0; i < POS_WIDTH; ++i)
    s[i] = gl_add(s[i], kRoundConstants[r * POS_WIDTH + i]);
  s[0] = pos_sbox(s[0]);
  pos_mds(s);
}

__device__ __forceinline__ void pos_permute(uint64_t s[POS_WIDTH]) {
  int r = 0;
#pragma unroll 1
  for (; r < POS_HALF_FULL; ++r) pos_full_round(s, r);
#pragma unroll 1
  for (; r < POS_HALF_FULL + POS_PARTIAL; ++r) pos_partial_round(s, r);
#pragma unroll 1
  for (; r < POS_ROUNDS; ++r) pos_full_round(s, r);
}
