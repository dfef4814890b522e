// Four-step NTT kernels for Hopper (sm_90a).
//
// Replaces city_rollup_tpu/core/pallas_ntt.py:
//   K1 _small_ntt with g -> _kernel_tw (+ _stages, _apply_fourstep_twiddle)
//   K2 _small_ntt without g -> _kernel_plain
//   the cross-block _tail_stage (jnp in the reference, a kernel here).
//
// Layout. The TPU kernel runs each transform down the sublanes of a
// (2^12, 128) VMEM tile: 4 MB of u64 pairs, far above a GPU block's 227 KB
// of shared memory. Here the gathers around the kernels (cuda_ntt.py) lay
// every sub-transform out as one contiguous row instead, so one block owns
// one segment of 2^ks values (32 KB at ks = 12): it loads the segment with
// fully coalesced reads, runs all ks radix-2 DIT stages in shared memory
// with one __syncthreads per stage, and writes the segment back once. The
// bit-reversed input order makes the first ks stages of a longer row
// independent per 2^ks segment, as in the reference; the remaining stages
// of K2 are one ntt_tail_kernel pass each.
//
// Bound. At the commit sizes the work is ~1 Goldilocks multiply per value
// per stage against 16 bytes of device traffic per value per pass, so the
// kernels are bound by memory bytes, not integer throughput: the design
// keeps every stage of a segment in shared memory and touches device
// memory once per pass. K1 also multiplies value k of row r by g_r^k (the
// four-step twiddle): each thread makes g^t once and then steps by
// g^blockDim, about one multiply per value, where the reference
// re-exponentiates every row.
#include <cuda_runtime.h>

#include "gl64.cuh"

namespace {

template <bool kTwiddle>
__global__ void ntt_block_kernel(const uint64_t* __restrict__ in,
                                 uint64_t* __restrict__ out,
                                 const uint64_t* __restrict__ tw,
                                 const uint64_t* __restrict__ g, int ks) {
  extern __shared__ uint64_t sh[];
  const int mk = 1 << ks;
  const size_t seg = blockIdx.x;
  const uint64_t* src = in + seg * mk;
  for (int i = threadIdx.x; i < mk; i += blockDim.x) sh[i] = src[i];
  __syncthreads();
  for (int s = 0; s < ks; ++s) {
    const int h = 1 << s;
    const uint64_t* tws = tw + (size_t)s * mk;  // row i: w^((i & (h-1)) * mk/2h)
    for (int u = threadIdx.x; u < (mk >> 1); u += blockDim.x) {
      const int i0 = ((u >> s) << (s + 1)) | (u & (h - 1));
      const int i1 = i0 + h;
      const uint64_t t = gl_mul(sh[i1], tws[i0]);
      const uint64_t e = sh[i0];
      sh[i0] = gl_add(e, t);
      sh[i1] = gl_sub(e, t);
    }
    __syncthreads();
  }
  uint64_t* dst = out + seg * mk;
  if (kTwiddle) {
    const uint64_t gs = g[seg];
    uint64_t p = gl_pow(gs, threadIdx.x);
    const uint64_t step = gl_pow(gs, blockDim.x);
    for (int k = threadIdx.x; k < mk; k += blockDim.x) {
      dst[k] = gl_mul(sh[k], p);
      p = gl_mul(p, step);
    }
  } else {
    for (int k = threadIdx.x; k < mk; k += blockDim.x) dst[k] = sh[k];
  }
}

// One cross-segment DIT stage s over rows of 2^log_m values: one butterfly
// per thread; neighbouring threads take neighbouring pairs (coalesced for
// 2^s >= 32, which every tail stage is at real sizes).
__global__ void ntt_tail_kernel(const uint64_t* __restrict__ in,
                                uint64_t* __restrict__ out,
                                const uint64_t* __restrict__ tw,
                                size_t butterflies, int log_m, int s) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= butterflies) return;
  const size_t row = t >> (log_m - 1);
  const size_t u = t & (((size_t)1 << (log_m - 1)) - 1);
  const size_t h = (size_t)1 << s;
  const size_t j = u & (h - 1);
  const size_t i0 = (row << log_m) + ((u >> s) << (s + 1)) + j;
  const uint64_t w = tw[((size_t)s << log_m) + j];
  const uint64_t e = in[i0];
  const uint64_t o = gl_mul(in[i0 + h], w);
  out[i0] = gl_add(e, o);
  out[i0 + h] = gl_sub(e, o);
}

}  // namespace

// in, out: (segs, 2^ks) contiguous. tw: the (ks * 2^ks) stage-twiddle table.
// g: one four-step seed per segment (K1), or null (K2). ks <= 12: a segment
// must fit the 48 KB of shared memory a block gets without opting in.
extern "C" int city_ntt_block(const uint64_t* in, uint64_t* out,
                              const uint64_t* tw, const uint64_t* g,
                              long long segs, int ks, void* stream) {
  const int mk = 1 << ks;
  int threads = mk >> 1;
  if (threads > 256) threads = 256;
  if (threads < 1) threads = 1;
  const size_t smem = (size_t)mk * sizeof(uint64_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (segs <= 0) return (int)cudaGetLastError();
  if (g != nullptr)
    ntt_block_kernel<true><<<(unsigned)segs, threads, smem, st>>>(in, out, tw,
                                                                 g, ks);
  else
    ntt_block_kernel<false><<<(unsigned)segs, threads, smem, st>>>(
        in, out, tw, nullptr, ks);
  return (int)cudaGetLastError();
}

// in, out: (rows, 2^log_m) contiguous. tw: the (log_m * 2^log_m) table.
extern "C" int city_ntt_tail(const uint64_t* in, uint64_t* out,
                             const uint64_t* tw, long long rows, int log_m,
                             int s, void* stream) {
  const size_t butterflies = (size_t)rows << (log_m - 1);
  const int threads = 256;
  const size_t blocks = (butterflies + threads - 1) / threads;
  if (blocks > 0)
    ntt_tail_kernel<<<(unsigned)blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        in, out, tw, butterflies, log_m, s);
  return (int)cudaGetLastError();
}
