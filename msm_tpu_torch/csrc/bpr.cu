// Kernel 8: phase 1 of the blocked bucket reduction on the word core,
// generic over the field. The chain body is in bpr.cuh, the kernel and its
// launch (BprLaunch<F>) in offpath.cuh; BN254's launch is instantiated here
// and each other curve's in csrc/curve_<name>_pairs.cu, and msm_bpr_phase1
// dispatches on the curve.
//
// Replaces msm_tpu/ops/pallas_bpr.py::make_bpr_phase1 (pallas_call at :97).
// The TPU kept (m, g) in VMEM scratch across the sequential grid axis of Bl
// steps and read the buckets descending through its index map; here a group
// of lanes keeps them in registers and its loop index runs backwards. The
// input stays step-major [G, Bl, T, L], so at every step neighbouring
// groups read neighbouring rows (80 B at 8 words, 120 B at 12).
//
// Bound: integer multiply-adds, 2 * Bl dependent complete additions (12
// Montgomery products each) per chain, of which the first two start from
// the identity and need none. At the 2^20 shape there are only
// G * T = 16 * 512 chains of 128 additions: one thread per chain fills 256
// warps, fewer than the card's 528 schedulers, and a warp on this core
// issues about one instruction in six cycles (a product's carries are a
// dependent chain; PERF.md). The design:
//   - a group of LANES = 4 lanes per chain, so the 2^20 shape has 1024
//     warps in 128 blocks, one wave on the card's 132 SMs;
//   - two lanes of the group run the m additions and two the acc additions
//     a step behind (step b's m + B[b] and step b + 1's acc + m are
//     independent), each pair splitting its addition's levels of six
//     products three a lane (csrc/lanes32.cuh), so no lane idles, and each
//     lane repeats only its own addition's sums and differences;
//   - the twin's additions in its order, so the result is the twin's,
//     limb for limb.
// LANES and the block size are the fastest of scripts/torch_bpr_variants.py's
// sweep (PERF.md): 8 or 32 lanes, 64 or 128 threads ran slower, as did 1 or
// 2 lanes and a group running both additions in turn in its earlier sweeps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "offpath.cuh"

MSM_EXTERN_OTHER_FIELDS(BprLaunch)

// b* [G, Bl, T, L]; m*, g* [G, T, L]; every pointer rows_aligned<F>
// (row_align<L>; a word in the narrow build)
extern "C" int msm_bpr_phase1(const int32_t* bx, const int32_t* by,
                              const int32_t* bz, int32_t* mx, int32_t* my,
                              int32_t* mz, int32_t* gx, int32_t* gy,
                              int32_t* gz, int64_t groups, int Bl, int T,
                              int curve, int width, void* stream) {
  MSM_FIELD_SWITCH(curve, BprLaunch, (bx, by, bz, mx, my, mz, gx, gy, gz,
                                      groups, Bl, T, width, (cudaStream_t)stream))
}
