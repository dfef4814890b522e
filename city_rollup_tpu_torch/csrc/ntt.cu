// Four-step NTT kernels for Hopper (sm_90a).
//
// Replaces city_rollup_tpu/core/pallas_ntt.py:
//   K1 _small_ntt with g -> _kernel_tw (+ _stages, _apply_fourstep_twiddle)
//   K2 _small_ntt without g -> _kernel_plain
//   the cross-block _tail_stage (jnp in the reference, a kernel here).
//
// A length-N transform is the (n2, n1) matrix x[a * n1 + c] (N = n2 n1):
//   K1: for each column c, the length-n2 DFT over a, times w_N^(c k2)
//       -> Y[k2, c];
//   K2: for each row k2, the length-n1 DFT over c -> X[k1 n2 + k2].
// The reference gathers and transposes around its kernels so that each
// sub-transform is one TPU tile. Here the kernels address the matrix
// themselves, and nothing else passes over the data:
//   - K1 reads the coefficients as they are: value j = a n1 + c of a row of
//     n_in values, times pre[j] (the coset's shift^j); it reads nothing for
//     j >= n_in, the zero padding of an LDE (7/8 of the matrix at rate 3).
//   - K1 writes Y tiled: T = min(4, n2) neighbouring rows k2 interleaved,
//     ((k2 / T) n1 + c) T + k2 % T, so that K1's stores and K2's loads both
//     fill whole 32-byte sectors.
//   - K2 writes X in natural order (the reference's step-5 transpose), or at
//     -k mod N for an inverse transform (the inverse DFT is the forward one
//     read backwards), times scale[k & mask] (n^-1, and shift^-k for a coset).
//
// Inside a block. A block owns `cols` neighbouring transforms of length
// M = 2^log_m (cols * M * 8 bytes <= 128 KB of shared memory; M <= 2^13, so
// 2^25 = 2^13 (K1) x 2^12 (K2): K1 reads only an LDE's nonzero rows, K2
// writes every value with a stride and takes the shorter, wider tiles) and
// runs the DFT as P passes of radix 2^r (r <= 4): x[a_hi S + a_lo] -> for
// each a_lo a radix-2^r DFT over a_hi in registers, times w_L^(a_lo k_lo),
// then the length-S DFTs of the results, in place. So the data crosses
// shared memory P - 1 times (twice at M = 2^12, not once per radix-2
// stage). Input order is natural; the output lands in digit-reversed
// place, and the last pass maps each thread to its outputs' natural index.
// Inside a radix-16 DFT every twiddle is a power of w_16 = 2^156: a
// multiply by 2^e is a shift and one reduction (gl_mul_pow2_lazy), and
// 2^96 = -1 turns a sign into swapped outputs. The DFT is compile-time
// template steps, so that its array indices are constants (registers; a
// runtime index puts the values in local memory). In K1's first pass only
// the first inputs of a group can be nonzero (an LDE's padding), and the
// DFT's first stages are copies. Values stay lazy (any u64 congruent mod p)
// between passes and are made canonical once, on the way out.
//
// Bound. Per value a middle radix-16 pass is ~85 SASS instructions (the
// DFT ~47, the twiddle product ~21, set-up and shared memory the rest),
// against 16 bytes of device traffic per value per kernel: the kernels are
// bound by instruction dispatch, not by bytes (PERF.md).

#include <cuda_runtime.h>

#include <utility>

#include "gl64.cuh"

namespace {

// w_16 = h_primitive_root_of_unity(4) = 2^156 mod p; the wrapper checks it
// (cuda_ntt.W16_LOG2).
constexpr int kW16Log2 = 156;

struct NttArgs {
  const uint64_t* in;
  uint64_t* out;
  const uint64_t* pw;     // w_M^e, e < M: the twiddles between passes
  const uint64_t* tw;     // K1: w_N^e = tw[e & (2^tw_h - 1)] tw[2^tw_h + (e >> tw_h)]
  const uint64_t* scale;  // K1: pre[j] (or null); K2: scale[k & scale_mask] (or null)
  long long n_in;         // K1: row length of the input
  long long scale_mask;
  int batch;
  int log_n2, log_n1;     // the four-step matrix
  int log_m;              // the transform a block runs (K1: n2; K2: a segment of n1)
  int log_t;              // K2: segment c = r + 2^log_t u (0: whole rows)
  int log_cols;
  int tw_h;
  int reverse;            // K2: write X[k] at -k mod N
};

__host__ __device__ constexpr int brev_c(int x, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((x >> i) & 1) << (bits - 1 - i);
  return r;
}

__device__ __forceinline__ int brev_rt(int x, int bits) {
  return bits ? (int)(__brev((unsigned)x) >> (32 - bits)) : 0;
}

// Shared-memory slot of position pos (the cols values of one position are
// neighbours): the low b = 4 - log_cols bits XORed with every higher b-bit
// chunk, so that the 16 threads of a half-warp, at any stride a pass gives
// them, reach 16 distinct 8-byte banks (no conflicts at the commit's
// shapes, by a model of the passes). It is linear over GF(2), and a pass's
// positions base + (j << logS) have disjoint bits, so the slot of each is
// swz(base) XOR the slots of j's bits. pos < 2^14.
__device__ __forceinline__ int swz(int pos, int log_cols) {
  const int b = 4 - log_cols;
  const int h = (pos >> b) ^ (pos >> 2 * b) ^ (pos >> 3 * b) ^
                (pos >> 4 * b) ^ (pos >> 5 * b) ^ (pos >> 6 * b) ^
                (pos >> 7 * b);
  return pos ^ (h & ((1 << b) - 1));
}

// a + w b, a - w b with w = 2^E mod p (0 <= E < 192).
template <int E>
__device__ __forceinline__ void butterfly(uint64_t& a, uint64_t& b) {
  constexpr bool kNeg = E >= 96;
  constexpr int kF = E % 96;
  uint64_t t;
  if constexpr (kF == 0)
    t = b;
  else if constexpr (kF < 64)
    t = gl_mul_pow2_lazy(b, kF);
  else
    t = gl_mul_lazy(b, gl_pow2_const(kF));
  t = gl_canonicalize(t);
  const uint64_t s = gl_add_lazy(a, t), d = gl_sub_lazy(a, t);
  a = kNeg ? d : s;
  b = kNeg ? s : d;
}

// The radix-2^RL DFT in registers, as compile-time steps so that every
// index is a constant (a register, never local memory). Radix-2 DIT over
// the bit-reversed view u[i] = v[brev(i)]; stage S's twiddles are powers of
// w_16 = 2^156: w_{2^(S+1)}^j = w_16^(j 2^(3-S)).
template <int RL, int S, int I>
__device__ __forceinline__ void dft_step(uint64_t* v) {
  constexpr int kH = 1 << S;
  constexpr int kJ = I & (kH - 1);
  constexpr int kI0 = ((I >> S) << (S + 1)) | kJ;
  butterfly<(kW16Log2 * kJ * (8 >> S)) % 192>(
      v[brev_c(kI0, RL)], v[brev_c(kI0 + kH, RL)]);
}

template <int RL, int S, int... I>
__device__ __forceinline__ void dft_stage(uint64_t* v,
                                          std::integer_sequence<int, I...>) {
  (dft_step<RL, S, I>(v), ...);
}

// With S0 > 0 only v[0..2^(RL-S0)) may be nonzero: in the bit-reversed view
// each block of 2^S0 then holds one nonzero value first, which the first
// S0 stages only copy across the block.
template <int RL, int S0, int I>
__device__ __forceinline__ void dft_copy(uint64_t* v) {
  if constexpr ((I & ((1 << S0) - 1)) != 0)
    v[brev_c(I, RL)] = v[brev_c(I & ~((1 << S0) - 1), RL)];
}

template <int RL, int S0, int... I>
__device__ __forceinline__ void dft_copies(uint64_t* v,
                                           std::integer_sequence<int, I...>) {
  (dft_copy<RL, S0, I>(v), ...);
}

template <int RL, int S>
__device__ __forceinline__ void dft_stages(uint64_t* v) {
  if constexpr (S < RL) {
    dft_stage<RL, S>(
        v, std::make_integer_sequence<int, (1 << RL) / 2>{});
    dft_stages<RL, S + 1>(v);
  }
}

// x[k] <- X[k] = sum_j v[j] w^(jk), w = w_{2^RL}, natural order in and out.
template <int K, int RL>
__device__ __forceinline__ void dft_out(const uint64_t* v, uint64_t* x) {
  x[K] = v[brev_c(K, RL)];
}

template <int RL, int S0, int... K>
__device__ __forceinline__ void dft_regs_seq(uint64_t* v, uint64_t* x,
                                             std::integer_sequence<int, K...>
                                                 seq) {
  dft_copies<RL, S0>(v, seq);
  dft_stages<RL, S0>(v);
  (dft_out<K, RL>(v, x), ...);
}

template <int RL, int S0>
__device__ __forceinline__ void dft_regs(uint64_t* v, uint64_t* x) {
  dft_regs_seq<RL, S0>(
      v, x, std::make_integer_sequence<int, 1 << RL>{});
}

// K1's first pass: only the first 2^z of the 2^RL inputs can be nonzero
// (the rest are an LDE's zero padding).
template <int RL>
__device__ __forceinline__ void dft_regs_nonzero(uint64_t* v, uint64_t* x,
                                                 int z) {
  switch (RL - z) {
    case 0: dft_regs<RL, 0>(v, x); break;
    case 1: dft_regs<RL, (RL >= 1)>(v, x); break;
    case 2: dft_regs<RL, (RL >= 2) * 2>(v, x); break;
    case 3: dft_regs<RL, (RL >= 3) * 3>(v, x); break;
    default: dft_regs<RL, RL>(v, x); break;
  }
}

__device__ __forceinline__ uint64_t tw_pow(const NttArgs& a, long long e) {
  return gl_mul(__ldg(a.tw + (e & ((1LL << a.tw_h) - 1))),
                __ldg(a.tw + (1LL << a.tw_h) + (e >> a.tw_h)));
}

struct Block {
  int c0;       // K1: first column
  int k20;       // K2: first row
  int seg, r;    // K2: segment index, and its residue brev(seg)
  const uint64_t* in;
  uint64_t* out;
  int P, base, extra;  // pass p has radix 2^(base + (p < extra))
};

// Tiled index of Y[k2, c] within one batch row.
__device__ __forceinline__ int y_index(const NttArgs& a, int k2, int c) {
  const int lt = a.log_n2 < 2 ? a.log_n2 : 2;
  return ((((k2 >> lt) << a.log_n1) + c) << lt) + (k2 & ((1 << lt) - 1));
}

template <int RL, bool kK1>
__device__ __forceinline__ void run_pass(const NttArgs& a, const Block& bk,
                                         uint64_t* sh, int p, int consumed) {
  constexpr int R = 1 << RL;
  const int lc = a.log_cols;
  const int logL = a.log_m - consumed;
  const int logS = logL - RL;
  const int lpre = a.log_m - RL;  // last pass: output k sits k << lpre on
  const bool first = p == 0, last = p == bk.P - 1;
  const int groups = (1 << (a.log_m - RL)) << lc;
  const int lt = a.log_n2 < 2 ? a.log_n2 : 2;
  // K1's first pass: inputs j >= 2^z of a group lie in the zero padding
  int z = RL;
  if (kK1 && first) {
    const int log_in = 63 - __clzll(a.n_in);
    const int nz = log_in > a.log_n1 ? log_in - a.log_n1 : 0;  // rows
    z = nz - logS < 0 ? 0 : (nz - logS > RL ? RL : nz - logS);
  }
  int bit_slot[RL > 0 ? RL : 1];  // shared-memory word offset of j's bits
#pragma unroll
  for (int i = 0; i < RL; ++i) bit_slot[i] = swz(1 << (logS + i), lc) << lc;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int col = g & ((1 << lc) - 1);
    const int rest = g >> lc;
    int base, a_lo = 0;
    if (last) {
      // rest: the natural index of the thread's first output; its place
      // is the digit reversal over the earlier passes
      int kap = 0, x = rest;
      for (int q = 0; q < p; ++q) {
        const int rq = bk.base + (q < bk.extra);
        kap = (kap << rq) | (x & ((1 << rq) - 1));
        x >>= rq;
      }
      base = kap << RL;
    } else {
      a_lo = rest & ((1 << logS) - 1);
      base = ((rest >> logS) << logL) + a_lo;
    }
    const int slot0 = (swz(base, lc) << lc) | col;
    int slot[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      slot[j] = slot0;
#pragma unroll
      for (int i = 0; i < RL; ++i)
        if ((j >> i) & 1) slot[j] ^= bit_slot[i];
    }
    uint64_t v[R];
    if (!first) {
#pragma unroll
      for (int j = 0; j < R; ++j) v[j] = sh[slot[j]];
    } else if (kK1) {
      // row base + (j << logS) of column c0 + col: flat index
      // i0 + (j << (logS + log_n1)), read while below n_in
      const int i0 = (base << a.log_n1) + (int)bk.c0 + col;
      const int sh_j = logS + a.log_n1;
      const uint64_t* src = bk.in + i0;
      const uint64_t* pre = a.scale == nullptr ? nullptr : a.scale + i0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        uint64_t x = 0;
        if (j < (1 << z) && i0 + (j << sh_j) < a.n_in) {
          x = src[j << sh_j];
          if (pre != nullptr)
            x = gl_mul_lazy(x, __ldg(pre + (j << sh_j)));
        }
        v[j] = x;
      }
    } else {
      const uint64_t* src =
          bk.in + y_index(a, bk.k20 + col, (base << a.log_t) + bk.r);
      const int sh_j = logS + a.log_t + lt;
#pragma unroll
      for (int j = 0; j < R; ++j) v[j] = src[j << sh_j];
    }
    uint64_t out[R];  // output k of the group's DFT
    if (kK1 && first)
      dft_regs_nonzero<RL>(v, out, z);
    else
      dft_regs<RL, 0>(v, out);
    if (!last) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        uint64_t x = out[k];
        if (k > 0) {
          const uint64_t w = __ldg(a.pw + ((a_lo * k) << consumed));
          x = gl_mul_lazy(x, w);
        }
        sh[slot[k]] = x;
      }
    } else if (kK1) {
      // Y[k2, c] = X[k2] w_N^(c k2), k2 = rest + (k << lpre)
      const int c = (int)bk.c0 + col;
      uint64_t w = tw_pow(a, (long long)c * rest);
      const uint64_t step = tw_pow(a, (long long)c << lpre);
      if (lpre >= lt) {
        uint64_t* dst = bk.out + y_index(a, rest, c);
#pragma unroll
        for (int k = 0; k < R; ++k) {
          dst[k << (lpre + a.log_n1)] = gl_mul(out[k], w);
          if (k + 1 < R) w = gl_mul_lazy(w, step);
        }
      } else {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          bk.out[y_index(a, rest + (k << lpre), c)] = gl_mul(out[k], w);
          if (k + 1 < R) w = gl_mul_lazy(w, step);
        }
      }
    } else {
      const int k2 = bk.k20 + col;
      if (a.log_t > 0) {
        uint64_t* dst =
            bk.out + (k2 << a.log_n1) + (bk.seg << a.log_m) + rest;
#pragma unroll
        for (int k = 0; k < R; ++k)
          dst[k << lpre] = gl_canonicalize(out[k]);
      } else if (!a.reverse && a.scale == nullptr) {
        uint64_t* dst = bk.out + (rest << a.log_n2) + k2;
#pragma unroll
        for (int k = 0; k < R; ++k)
          dst[k << (lpre + a.log_n2)] = gl_canonicalize(out[k]);
      } else {
        // an inverse transform: X[k] at -k mod N, times scale
        const int n_mask = (1 << (a.log_n1 + a.log_n2)) - 1;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          int dest = (((rest + (k << lpre)) << a.log_n2) + k2);
          if (a.reverse) dest = (-dest) & n_mask;
          uint64_t x = gl_canonicalize(out[k]);
          if (a.scale != nullptr)
            x = gl_mul(x, __ldg(a.scale + (dest & (int)a.scale_mask)));
          bk.out[dest] = x;
        }
      }
    }
  }
}

// Passes of radix up to 2^kRadixLog: 3 passes at 2^12, 4 at 2^13.
constexpr int kRadixLog = 4;

// At most 128 registers a thread, for blocks of 512 threads (a ceiling that
// cost nothing, measured against 255 registers at 256 threads).
template <bool kK1>
__global__ void __launch_bounds__(512) ntt_block_kernel(const NttArgs a) {
  extern __shared__ uint64_t sh[];
  // Block order: runs of 16 neighbouring tiles (column groups), then the
  // batch, so that the blocks resident at one time read (K1) and write
  // (K2) neighbouring 16- or 32-byte pieces of the same rows, which L2 and
  // the DRAM pages then see together.
  const long long n = 1LL << (a.log_n1 + a.log_n2);
  const long long groups = ((kK1 ? 1LL << a.log_n1 : 1LL << a.log_n2) >>
                            a.log_cols);
  const long long tiles = groups << (kK1 ? 0 : a.log_t);
  const long long run = tiles < 16 ? tiles : 16;
  const long long bid = blockIdx.x;
  const long long b = (bid / run) % a.batch;
  const long long tile = bid / (run * a.batch) * run + bid % run;
  Block bk{};
  if (kK1) {
    bk.c0 = (int)tile << a.log_cols;
    bk.in = a.in + b * a.n_in;
  } else {
    bk.k20 = (int)(tile % groups) << a.log_cols;
    bk.seg = (int)(tile / groups);
    bk.r = brev_rt(bk.seg, a.log_t);
    bk.in = a.in + b * n;
  }
  bk.out = a.out + b * n;
  bk.P = a.log_m > 0 ? (a.log_m + kRadixLog - 1) / kRadixLog : 1;
  bk.base = a.log_m / bk.P;
  bk.extra = a.log_m % bk.P;
  int consumed = 0;
  for (int p = 0; p < bk.P; ++p) {
    const int rl = bk.base + (p < bk.extra);
    switch (rl) {
      case 0: run_pass<0, kK1>(a, bk, sh, p, consumed); break;
      case 1: run_pass<1, kK1>(a, bk, sh, p, consumed); break;
      case 2: run_pass<2, kK1>(a, bk, sh, p, consumed); break;
      case 3: run_pass<3, kK1>(a, bk, sh, p, consumed); break;
      default: run_pass<4, kK1>(a, bk, sh, p, consumed); break;
    }
    consumed += rl;
    if (p + 1 < bk.P) __syncthreads();
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

template <bool kK1>
int launch(const NttArgs& a, long long blocks, int threads,
           cudaStream_t st) {
  const int passes =
      a.log_m > 0 ? (a.log_m + kRadixLog - 1) / kRadixLog : 1;
  const size_t smem =
      passes > 1 ? ((size_t)1 << (a.log_m + a.log_cols)) * sizeof(uint64_t)
                 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_block_kernel<kK1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ntt_block_kernel<kK1><<<(unsigned)blocks, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

bool bad_shape(const NttArgs& a, int threads) {
  return a.batch <= 0 || a.log_m < 0 ||
         a.log_cols < 0 || a.log_cols > 2 || a.log_n1 + a.log_n2 > 30 ||
         (a.log_m + a.log_cols) > 14 || threads <= 0 || threads > 512 ||
         (threads & 31) != 0;
}

}  // namespace

// K1. in: (batch, n_in) coefficients (n_in <= N, a power of two), out:
// (batch, N) Y tiled. pw: w_n2^e (e < n2); tw: the two-level w_N table;
// pre: n_in multipliers or null. 2^log_cols columns a block.
extern "C" int city_ntt_k1(const uint64_t* in, uint64_t* out,
                           const uint64_t* pw, const uint64_t* tw,
                           const uint64_t* pre, long long n_in, int batch,
                           int log_n2, int log_n1, int tw_h, int log_cols,
                           int threads, void* stream) {
  NttArgs a{};
  a.in = in; a.out = out; a.pw = pw; a.tw = tw; a.scale = pre;
  a.n_in = n_in; a.batch = batch; a.log_n2 = log_n2; a.log_n1 = log_n1;
  a.log_m = log_n2; a.log_cols = log_cols; a.tw_h = tw_h;
  if (bad_shape(a, threads) || log_cols > log_n1 ||
      n_in <= 0 || n_in > (1LL << (log_n1 + log_n2)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)batch << (log_n1 - log_cols);
  return launch<true>(a, blocks, threads, static_cast<cudaStream_t>(stream));
}

// K2. in: (batch, N) Y tiled; pw: w_M^e (e < M = 2^(log_n1 - log_t)).
// log_t = 0: out (batch, N) in natural order (at -k mod N if reverse),
// times scale[k & scale_mask] if scale is given. log_t > 0: out
// (batch * n2, n1) rows, segment s at s * M holding the DFT over u of
// Y[k2, brev(s) + 2^log_t u] (the first log_n1 - log_t stages of a DIT
// transform; ntt_tail_kernel runs the rest).
extern "C" int city_ntt_k2(const uint64_t* in, uint64_t* out,
                           const uint64_t* pw, const uint64_t* scale,
                           long long scale_mask, int batch, int log_n2,
                           int log_n1, int log_t, int reverse, int log_cols,
                           int threads, void* stream) {
  NttArgs a{};
  a.in = in; a.out = out; a.pw = pw; a.scale = scale;
  a.scale_mask = scale_mask; a.batch = batch; a.log_n2 = log_n2;
  a.log_n1 = log_n1; a.log_m = log_n1 - log_t; a.log_t = log_t;
  a.log_cols = log_cols; a.reverse = reverse;
  if (bad_shape(a, threads) || log_t < 0 ||
      log_cols > (log_n2 < 2 ? log_n2 : 2) ||
      (log_t > 0 && (reverse || scale != nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)batch << (log_n2 - log_cols)) << log_t;
  return launch<false>(a, blocks, threads,
                       static_cast<cudaStream_t>(stream));
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
