// Batched complete point addition (RCB16 Algorithm 7) on the word core.
//
// Replaces: msm_tpu/ops/pallas_curve.py::make_point_add (pallas_call at
// :467). The TPU kernel existed to keep a whole add's 12 Montgomery
// products in VMEM instead of round-tripping each product through HBM.
//
// On the H100 one thread owns one add (csrc/point_add.cuh point_add_row),
// so nothing leaves registers between products. Bound: integer
// instruction throughput, 12 products of 2 x 64 word multiply-adds each
// (csrc/fe32.cuh), whose carry handling's add and logic instructions
// outnumber the multiplies (PERF.md), plus six balanced-row loads; the
// 9 x 80 B of rows per add come second. The design:
//   - the word core with pt32_add inlined: no out-of-line call, no stack
//     frame (the 13-bit core took 2 x 400 multiply-adds per product at ~255
//     registers);
//   - __launch_bounds__(128, F::BLOCKS_PER_SM), as the scan (csrc/scan.cu):
//     at most 128 registers, 4 blocks of 128 per SM at 8 words an element
//     (255 registers, 2 blocks at the BLS12 curves' 12);
//   - each 80-byte row read with five 16-byte loads and written with five
//     16-byte stores (scripts/torch_add_total_variants.py times this
//     against staging a block's rows through shared memory, PERF.md).
// Small batches are latency-bound instead: the naive path's running sum
// launches 510 adds of 32 points each, one after another, and one add in
// one thread is 12 products deep. For a batch whose warps fit in one wave
// (ops/cuda_curve.point_add_lanes), k_point_add_lanes gives each add a
// warp that splits its products over the lanes (two products deep, as the
// Horner ladder's chain does).
#include <cuda_runtime.h>

#include "plain.cuh"

using namespace msm;

MSM_EXTERN_OTHER_FIELDS(PointAddLaunch)

// Every pointer [n, L] of the curve's L, aligned as the rows' vector loads
// need (16 bytes at L = 20); lanes != 0: a warp per add.
extern "C" int msm_point_add(const int32_t* ax, const int32_t* ay,
                             const int32_t* az, const int32_t* bx,
                             const int32_t* by, const int32_t* bz, int32_t* ox,
                             int32_t* oy, int32_t* oz, int64_t n, int lanes,
                             int curve, void* stream) {
  MSM_FIELD_SWITCH(curve, PointAddLaunch,
                   (ax, ay, az, bx, by, bz, ox, oy, oz, n, lanes,
                    (cudaStream_t)stream))
}
