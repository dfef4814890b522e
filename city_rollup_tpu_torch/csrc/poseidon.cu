// Poseidon permutation, sponge and absorb kernels for Hopper (sm_90a).
//
// Replaces city_rollup_tpu/core/pallas_poseidon.py:
//   K3 permute_t -> _permute_kernel (pallas_poseidon.py:183; FRI grinding)
//   K4 _sponge_t_impl -> _sponge_kernel (leaf hashing, every Merkle level)
//   K5 absorb_t -> _absorb_kernel (the streamed commit's slab absorb)
//
// Layout. As in the reference, the data is transposed: column j of an
// (n, B) array is one sponge input. One thread owns one column: its 12-lane
// state lives in registers across all ceil(n/8) permutations, and a warp's
// loads of row r touch 32 neighbouring u64 (coalesced).
//
// Bound. One permutation is ~470 Goldilocks multiplies (the S-boxes) and
// 30 x 288 small-constant 32-bit multiply-adds (the MDS): counted as
// chip_smoke.OPS_PERMUTATION integer operations per state, for all three
// kernels alike. Against that a permutation moves at most 192 bytes (K3:
// 12 u64 in, 12 out), and a 64-felt leaf takes 8 of them against 512 bytes
// of input, so all three are bound by integer throughput, not memory bytes.
// The design spends nothing on data movement inside a hash (no shared
// memory, no re-reads) and keeps the MDS as immediate-constant
// multiply-adds with one reduction per lane.
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

unsigned blocks_for(size_t B) {
  return (unsigned)((B + kThreads - 1) / kThreads);
}

}  // namespace

// Copies the 360 round constants (host memory) into constant memory of the
// current device. Called once per device before the first launch.
extern "C" int city_poseidon_init(const uint64_t* round_constants) {
  cudaMemcpyToSymbol(kRoundConstants, round_constants,
                     sizeof(uint64_t) * POS_ROUNDS * POS_WIDTH);
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
