// Batched Montgomery exponentiation a^e, one lane per thread: the Fermat
// inversion (e = p - 2) of the pair-compression chains.
//
// Replaces: msm_tpu/ops/pallas_inv.py::make_mont_pow (pallas_call at :92).
// The TPU ran one grid step per exponent bit with the [L, R] accumulator in
// VMEM; here each thread keeps its accumulator in registers for the whole
// chain (pow32_window in pow32.cuh, on the word core). Generic over the
// field: the kernel and its launch are in pairs.cuh (PowLaunch<F>);
// msm_mont_pow dispatches on the curve, whose instantiation is BN254's here
// and each other curve's in csrc/curve_<name>_pairs.cu. At the BLS12
// curves' 12 words the table takes 45 KiB of a block's 48 KiB of static
// shared memory, and e = p - 2 has 381 bits (96 digits).
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

#include "pairs.cuh"

using namespace msm;

MSM_EXTERN_OTHER_FIELDS(PowLaunch)

// a, out [B, L, R] (limbs-first; a balanced, out canonical), L the curve's
// limbs; e_words: host array of the exponent's 32-bit words, least
// significant first, covering nbits bits.
extern "C" int msm_mont_pow(const int32_t* a, int32_t* out,
                            const uint32_t* e_words, int nbits, int64_t batch,
                            int R, int curve, int width, void* stream) {
  if (nbits < 0 || nbits > 32 * POW_EXP_WORDS) return (int)cudaErrorInvalidValue;
  pow_exp_words e = {};
  for (int i = 0; i < (nbits + 31) / 32; ++i) e.w[i] = e_words[i];
  MSM_FIELD_SWITCH(curve, PowLaunch,
                   (a, out, e, nbits, batch, R, width, (cudaStream_t)stream))
}
