// Batched Montgomery exponentiation a^e, one lane per thread: the Fermat
// inversion (e = p - 2) of the pair-compression chains.
//
// Replaces: msm_tpu/ops/pallas_inv.py::make_mont_pow (pallas_call at :92).
// The TPU ran one grid step per exponent bit with the [L, R] accumulator in
// VMEM; here each thread keeps its accumulator in registers for the whole
// chain (pow32_window in pow32.cuh, on the word core).
//
// Bound: the latency of one lane's chain of dependent Montgomery products
// (325 for e = p - 2: 253 squarings, 72 products). There is one lane per
// compressed chain (16 x 2048 at 2^20 and at 2^16), ~8 warps per SM, so
// the design shortens the chain and each link of it:
//   - the word core, every function inlined, no out-of-line call;
//   - a fixed 4-bit window in place of square-and-multiply (364 products
//     for p - 2), its table of a^1 .. a^15 in shared memory laid out
//     [entry][word][thread] (conflict-free; 480 B a thread);
//   - the squarings by fe32_sqr_sym (36 word products for a^2 in place of
//     64);
//   - the exponent copied from the parameter bank into shared memory by
//     one thread at block start with constant indices (no stack frame);
//     every thread reads the same digit, a broadcast, and branches the
//     same way. Not a __constant__ symbol: two launches in flight on two
//     streams would race on it.
// scripts/torch_suffix_pow_variants.py times this kernel against the
// binary method with and without the squaring, the window with fe32_sqr,
// 64- and 128-thread blocks and the 13-bit kernel this one replaced
// (PERF.md).
#include <cuda_runtime.h>

#include "pow32.cuh"

using namespace msm;

constexpr int EXP_WORDS = 32;  // exponents of up to 1024 bits
constexpr int THREADS = 64;
constexpr int TABLE_WORDS = POW_TABLE * NW * THREADS;  // 30 KiB a block

struct exp_words {
  uint32_t w[EXP_WORDS];
};

__global__ void __launch_bounds__(THREADS)
    k_mont_pow(const int32_t* __restrict__ a, int32_t* __restrict__ out,
               const exp_words e, int nbits, int R) {
  __shared__ uint32_t ew[EXP_WORDS];
  __shared__ uint32_t tab[TABLE_WORDS];
  if (threadIdx.x == 0) {
    MSM_UNROLL
    for (int i = 0; i < EXP_WORDS; ++i) ew[i] = e.w[i];
  }
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t o = (int64_t)blockIdx.y * L * R + r;
  int32_t v[L];
  MSM_UNROLL
  for (int i = 0; i < L; ++i) v[i] = a[o + i * (int64_t)R];
  fe32 x, y;
  fe32_from_balanced(x, v);
  pow32_window(y, x, ew, nbits, tab + threadIdx.x, THREADS);
  fe32_store_limbs_strided(out + o, R, y);
}

// a, out [B, L, R] (limbs-first; a balanced, out canonical); e_words: host
// array of the exponent's 32-bit words, least significant first, covering
// nbits bits.
extern "C" int msm_mont_pow(const int32_t* a, int32_t* out,
                            const uint32_t* e_words, int nbits, int64_t batch,
                            int R, void* stream) {
  if (nbits < 0 || nbits > 32 * EXP_WORDS) return (int)cudaErrorInvalidValue;
  exp_words e = {};
  for (int i = 0; i < (nbits + 31) / 32; ++i) e.w[i] = e_words[i];
  if (batch > 0 && R > 0) {
    const dim3 grid((unsigned)((R + THREADS - 1) / THREADS), (unsigned)batch);
    k_mont_pow<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, out, e, nbits, R);
  }
  return (int)cudaGetLastError();
}
