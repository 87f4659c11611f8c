// Sum of N points per subtask on the word core: [G, N, L] balanced limbs in,
// [G, L] canonical limbs out.
//
// Replaces: msm_tpu/ops/pallas_prefix.py::make_point_total (pallas_call at
// :231), which summed the N points in one grid-less program, 128 VMEM lanes
// wide, and folded the lanes with pltpu.roll.
//
// Bound: the complete additions (12 products of 2 x 64 word multiply-adds
// each, N - 1 per subtask) over the card's integer rate; at the 2^16 MSM's
// and the blocked tail's shapes the serial depth of the tree instead. The
// points are read once (240 B each at 13-bit limbs). The design, two
// launches:
//   1. k_point_total, grid (nb, G) of 128 threads: thread j of subtask g
//      sums its contiguous run of k points (csrc/point_total.cuh
//      pt_total_run, loads with 16-byte vectors, pt32_add inlined). The
//      block folds its 128 sums in 7 levels: warps 2-3 hand theirs to warps
//      0-1 through shared memory as 96-byte pt32s, warp 1 to warp 0, and
//      warp 0 folds its lanes with __shfl_down_sync over a pt32's 3 NW words.
//      Whole warps drop out of the first two levels, so a block spends 8
//      warp-wide additions on its tree where a shuffle tree in every warp
//      would spend 22 (every lane of a warp adds at every level). The
//      block writes its partial as words to part [G, nb, 3 NW].
//   2. k_point_total_finish, one warp per subtask: lane l sums partials l,
//      l + 32, ..., and the warp folds only as many levels as the lanes
//      that hold a partial need; lane 0 writes canonical limbs.
// k and nb come from ops/cuda_prefix.point_total_plan: the fewest points
// per thread that keep G N / k threads within one wave of 4 blocks of 128
// per SM (__launch_bounds__(128, F::BLOCKS_PER_SM): at most 128 registers
// at 8 words an element; 2 blocks at 12), so every shape fills the card.
// The kernels and their launch are generic over the field
// (plain.cuh, PointTotalLaunch<F>); msm_point_total dispatches on
// the curve (csrc/dispatch.cuh). Serial depth: k - 1 + 7 additions, then
// ceil(nb / 32) - 1 + log2(min(nb, 32)). Each loop keeps its addition
// rolled (MSM_ROLLED): one copy of the formula per loop, not one per step.
// scripts/torch_add_total_variants.py times this against a finish by the
// last block to arrive (an atomic ticket) and against other plans
// (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "plain.cuh"

MSM_EXTERN_OTHER_FIELDS(PointTotalLaunch)

// p* [G, N, L] of the curve's L, aligned as the rows' loads need (16 bytes
// at L = 20); part [G, nb, 3D] scratch; o* [G, L]. The plan: k points per
// thread, nb blocks of 128 threads per subtask covering the N points
// (nb = 1 when N = 0).
extern "C" int msm_point_total(const int32_t* px, const int32_t* py,
                               const int32_t* pz, uint32_t* part, int32_t* ox,
                               int32_t* oy, int32_t* oz, int64_t groups,
                               int64_t N, int k, int nb, int curve,
                               void* stream) {
  MSM_FIELD_SWITCH(curve, PointTotalLaunch, (px, py, pz, part, ox, oy, oz,
                                             groups, N, k, nb,
                                             (cudaStream_t)stream))
}
