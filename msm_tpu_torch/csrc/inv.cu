// Batched Montgomery exponentiation a^e, one lane per thread: the Fermat
// inversion (e = p - 2) of the pair-compression chains.
//
// Replaces: msm_tpu/ops/pallas_inv.py::make_mont_pow (pallas_call at :92).
// The TPU ran one grid step per exponent bit with the [L, R] accumulator in
// VMEM; here each thread keeps its accumulator in registers for the whole
// square-and-multiply chain (fe_pow in field.cuh).
//
// Bound: latency of ~380 dependent Montgomery products per thread. There is
// one lane per compressed chain (4 x 1024 at 2^20), far too few threads to
// fill the card, so blocks are one warp wide: the lanes spread over as many
// SMs as possible instead of crowding a few. The exponent is a kernel
// argument (the parameter bank), read uniformly by every thread.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace msm;

constexpr int EXP_WORDS = 32;  // exponents of up to 1024 bits
constexpr int THREADS = 32;

struct exp_words {
  uint32_t w[EXP_WORDS];
};

__global__ void __launch_bounds__(THREADS)
    k_mont_pow(const int32_t* __restrict__ a, int32_t* __restrict__ out,
               const exp_words e, int nbits, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t o = (int64_t)blockIdx.y * L * R + r;
  fe x, y;
  fe_load_balanced_strided(x, a + o, R);
  fe_pow(y, x, e.w, nbits);
  fe_store_strided(out + o, R, y);
}

// a, out [B, L, R] (limbs-first); e_words: host array of the exponent's
// 32-bit words, least significant first, covering nbits bits.
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
