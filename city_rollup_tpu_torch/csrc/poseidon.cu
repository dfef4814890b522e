// Poseidon permutation, sponge and absorb kernels for Hopper (sm_90a).
//
// Replaces city_rollup_tpu/core/pallas_poseidon.py:
//   K3 permute_t -> _permute_kernel (pallas_poseidon.py:183; FRI grinding)
//   K4 _sponge_t_impl -> _sponge_kernel (leaf hashing, every Merkle level;
//      merkle_level_kernel is its entry for one tree level)
//   K5 absorb_t -> _absorb_kernel (the streamed commit's slab absorb)
//
// Layout. As in the reference, the data is transposed: column j of an
// (n, B) array is one sponge input. One thread owns one column: its 12-lane
// state lives in registers across all ceil(n/8) permutations, and a warp's
// loads of row r touch 32 neighbouring u64 (coalesced).
//
// Bound. A permutation moves at most 192 bytes (K3: 12 u64 in, 12 out), and
// a 64-felt leaf takes 8 of them against 512 bytes of input, while one
// permutation is ~470 Goldilocks multiplies (the S-boxes) and 30 x 288
// small-constant multiply-adds (the MDS), counted as
// chip_smoke.OPS_PERMUTATION operations per state for all three kernels
// alike: all three are bound by arithmetic, not memory bytes. The design
// spends nothing on data movement inside a hash (no shared memory, no
// re-reads); the core (poseidon.cuh) keeps the integer pipe, which sets the
// pace, to the S-boxes and the reductions, and runs the MDS on the FP64
// pipe beside it.
#include <cuda_runtime.h>

#include "poseidon.cuh"

namespace {

constexpr int kThreads = 128;

// in, out: (12, B). Each column is one state, permuted once.
__global__ void permute_kernel(const uint64_t* __restrict__ in,
                               uint64_t* __restrict__ out, size_t B) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  uint64_t s[POS_WIDTH];
#pragma unroll
  for (int i = 0; i < POS_WIDTH; ++i) s[i] = in[(size_t)i * B + j];
  pos_permute(s);
#pragma unroll
  for (int i = 0; i < POS_WIDTH; ++i) out[(size_t)i * B + j] = s[i];
}

// in: (n, B); out: (4, B). Overwrite-mode sponge, rate 8, from a zero state.
__global__ void sponge_kernel(const uint64_t* __restrict__ in,
                              uint64_t* __restrict__ out, int n, size_t B) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  uint64_t s[POS_WIDTH];
#pragma unroll
  for (int i = 0; i < POS_WIDTH; ++i) s[i] = 0;
  for (int start = 0; start < n; start += POS_RATE) {
    const int k = n - start < POS_RATE ? n - start : POS_RATE;
#pragma unroll
    for (int i = 0; i < POS_RATE; ++i)
      if (i < k) s[i] = in[(size_t)(start + i) * B + j];
    pos_permute(s);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) out[(size_t)i * B + j] = s[i];
}

// state: (12, B); chunk: (k, B); out: (12, B). Rows [0, k) are overwritten
// by the chunk, then the state is permuted. out may alias state.
__global__ void absorb_kernel(const uint64_t* state,
                              const uint64_t* __restrict__ chunk,
                              uint64_t* out, int k, size_t B) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  uint64_t s[POS_WIDTH];
#pragma unroll
  for (int i = 0; i < POS_WIDTH; ++i)
    s[i] = i < k ? chunk[(size_t)i * B + j] : state[(size_t)i * B + j];
  pos_permute(s);
#pragma unroll
  for (int i = 0; i < POS_WIDTH; ++i) out[(size_t)i * B + j] = s[i];
}

// One Merkle level: children (4, 2B) -> parents (4, B). Parent j is the
// sponge of columns 2j and 2j + 1 (8 felts, one permutation), read in place:
// the children need no copy into an (8, B) input first.
__global__ void merkle_level_kernel(const uint64_t* __restrict__ children,
                                    uint64_t* __restrict__ out, size_t B) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  uint64_t s[POS_WIDTH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i] = children[(size_t)i * 2 * B + 2 * j];
    s[4 + i] = children[(size_t)i * 2 * B + 2 * j + 1];
    s[8 + i] = 0;
  }
  pos_permute(s);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[(size_t)i * B + j] = s[i];
}

unsigned blocks_for(size_t B) {
  return (unsigned)((B + kThreads - 1) / kThreads);
}

}  // namespace

// Copies the tables (host memory, n u64 in PosTables order) into constant
// memory of the current device. Called once per device before the first
// launch. Returns -1 if n is not the size of PosTables.
extern "C" int city_poseidon_init(const uint64_t* tables, long long n) {
  if (n * (long long)sizeof(uint64_t) != (long long)sizeof(PosTables))
    return -1;
  cudaMemcpyToSymbol(kPos, tables, sizeof(PosTables));
  return (int)cudaGetLastError();
}

extern "C" int city_poseidon_permute(const uint64_t* in, uint64_t* out,
                                     long long B, void* stream) {
  if (B > 0)
    permute_kernel<<<blocks_for((size_t)B), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(in, out, (size_t)B);
  return (int)cudaGetLastError();
}

extern "C" int city_poseidon_sponge(const uint64_t* in, uint64_t* out, int n,
                                    long long B, void* stream) {
  if (B > 0)
    sponge_kernel<<<blocks_for((size_t)B), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(in, out, n,
                                                         (size_t)B);
  return (int)cudaGetLastError();
}

extern "C" int city_poseidon_absorb(const uint64_t* state,
                                    const uint64_t* chunk, uint64_t* out,
                                    int k, long long B, void* stream) {
  if (B > 0)
    absorb_kernel<<<blocks_for((size_t)B), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(state, chunk, out, k,
                                                         (size_t)B);
  return (int)cudaGetLastError();
}

extern "C" int city_poseidon_merkle_level(const uint64_t* children,
                                          uint64_t* out, long long B,
                                          void* stream) {
  if (B > 0)
    merkle_level_kernel<<<blocks_for((size_t)B), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(children, out,
                                                               (size_t)B);
  return (int)cudaGetLastError();
}
