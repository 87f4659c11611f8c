// The Horner ladder: sum_s 2^(chunk*s) * W_s over the S window sums, the
// last step of the cuZK MSM, batched over G independent ladders. Inputs
// w* [G, S, L] (balanced limbs, so plain PyTorch tensors are accepted);
// outputs o* [G, L], canonical limbs. The MSM runs it twice: once per
// window (G = S, S = 2) to fold each window sum W = 2^(c-1) pe_{B-1} -
// total (ops/scan.window_sum_from_pe; the blocked reduction's tail folds
// likewise), once over the S window sums (G = 1).
//
// Replaces msm_tpu/ops/pallas_prefix.py::make_horner_ladder (pallas_call at
// :335), which ran the ladder as one grid-less program.
//
// Bound: the serial chain. The work itself is a few microseconds of the
// card's integer rate, but 2^(chunk s) W_s needs chunk s doublings in any
// order, so the depth cannot shrink and only the latency of each product
// counts. The design goes after that latency:
//   - the word core (csrc/fe32.cuh; 2 x 64 word multiply-adds per product
//     where 13-bit limbs took 2 x 400), the doubling and the addition
//     inlined: no call, no stack frame;
//   - one warp splits each formula's independent products over its lanes
//     (csrc/horner.cuh horner_chain: 4 + 4 per doubling, 6 + 6 per
//     addition) and trades them with __shfl_sync, so the chain is
//     (S - 1)(2 chunk + 2) products deep instead of (S - 1)(8 chunk + 12)
//     in one thread (510 against 2100 at the 2^20 MSM's S = 16, chunk 16);
//   - the S window sums are canonicalized first, one per lane, into shared
//     memory, so their loads stay off the chain.
// The kernel and its launch are generic over the field (plain.cuh,
// HornerLaunch<F>); msm_horner dispatches on the curve
// (csrc/dispatch.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "plain.cuh"

MSM_EXTERN_OTHER_FIELDS(HornerLaunch)

// w* [G, S, L], o* [G, L], L the curve's; one block of one warp per ladder,
// its S window sums in shared memory.
extern "C" int msm_horner(const int32_t* wx, const int32_t* wy,
                          const int32_t* wz, int32_t* ox, int32_t* oy,
                          int32_t* oz, int64_t groups, int S, int chunk,
                          int curve, int width, void* stream) {
  MSM_FIELD_SWITCH(curve, HornerLaunch, (wx, wy, wz, ox, oy, oz, groups, S,
                                         chunk, width, (cudaStream_t)stream))
}
