// Per-lane inclusive prefix of mixed point additions over the bucket-sorted
// affine points -- the hot kernel of the MSM.
//
// Replaces: msm_tpu/ops/pallas_scan.py::make_scan_rows (pallas_call at
// :374), together with the sorted-order gather that fed it
// (msm_tpu/ops/scan.py:545, packed[perm2]): k_scan its plain mode, and
// k_scan_glv its GLV mode (:260-291), which reads the [N, 3D] table of
// rows x, beta x, y and takes x or beta x by bit 1 of an element's flags
// (scan.cuh's COORDS = 3). Under GLV a subtask's stream holds 2n
// elements, so each launch does twice the work at the same R.
//
// Generic over the field: the kernels and their launches are in plain.cuh
// (ScanLaunch<F>, ScanGlvLaunch<F>); msm_scan and msm_scan_rows_glv
// dispatch on the curve, whose instantiation is BN254's here and each other
// curve's in csrc/curve_*.cu.
//
// Layout: subtask g, lane r owns sorted positions [r*C, (r+1)*C); step c of
// lane r is element (c, r) of the step-major permutation. Thread (g, r)
// runs scan_lane (csrc/scan.cuh): it gathers the packed row of point
// perm[g, c, r], negates y when the flag's bit 0 is set, folds the point in
// with RCB16 Algorithm 8, and writes the running sum as one x||y||z row
// pe3[g, c, r, 0:3L]; the last step also goes to the lane totals
// t{x,y,z}[g, :, r], limbs-first (coalesced across lanes).
//
// Bound: 11 Montgomery products per step -- integer-multiply bound; the
// 64 B random gather and the 240 B row write per step come second. The
// design goes after what kept the first port at ~15x its bound:
//   - the word core (csrc/fe32.cuh): 8 x 32-bit words (BN254), 2 x 64 word
//     multiply-adds per product where 13-bit limbs took 2 x 400;
//   - the mixed addition inlined, the accumulator in registers across all
//     C steps, no out-of-line call; __launch_bounds__(128, 4) caps the
//     thread at 128 registers (ptxas then spills a few words to a 16-byte
//     frame), so 4 blocks of 128 fit on an SM and the 2^20 launch
//     (4 x 16384 lanes) is one wave of 132 x 512 threads (at the BLS12
//     curves' 12 words an element: F::BLOCKS_PER_SM = 2, 255 registers);
//   - one plan for every shape, the fastest at the 2^16 MSM's scan and
//     within 6% of the fastest at the 2^20 MSM's among the variants that
//     scripts/torch_scan_variants.py times (PERF.md): caps of 2 or 3
//     blocks (146 registers, no spill) ran ~24% slower at 2^20, and
//     256-thread blocks and loading the next step's row ahead (more spill)
//     ran 1-6% faster at 2^20 but 16-23% slower at 2^16;
//   - the row written as 15 16-byte stores, still 13-bit limbs: that is the
//     contract prefix_at and the row offsets read. A curve whose 3L limbs
//     are not a multiple of 4 pads its rows with zero limbs (scan.cuh
//     pe3_row: 64 at 21 limbs, 92 at 30), so its rows too take 16-byte
//     stores (with 4-byte stores of 63-limb rows the 21-limb curves'
//     scans ran ~2.4x slower, PERF.md).
// No tensor cores and no TMA: the work is exact 254-bit modular integer
// arithmetic, which wgmma and IMMA offer only through a decomposition into
// small products that costs more than it saves, and the gather reads
// random 64-byte rows, not tiles.
#include <cuda_runtime.h>

#include "plain.cuh"

using namespace msm;

MSM_EXTERN_OTHER_FIELDS(ScanLaunch)
MSM_EXTERN_OTHER_FIELDS(ScanGlvLaunch)

// packed [N, 2D] and pe3 [G, C, R, P] 16-byte aligned, D the curve's words
// per coordinate and P its pe3 row (3L limbs padded to a multiple of 4,
// scan.cuh pe3_row); perm, flags [G, C, R]; t* [G, L, R]
extern "C" int msm_scan(const int32_t* packed, const int32_t* perm,
                        const int32_t* flags, int32_t* pe3, int32_t* tx,
                        int32_t* ty, int32_t* tz, int64_t groups, int C, int R,
                        int curve, int width, void* stream) {
  MSM_FIELD_SWITCH(curve, ScanLaunch, (packed, perm, flags, pe3, tx, ty, tz,
                                       groups, C, R, width, (cudaStream_t)stream))
}

// packed [N, 3D] (the curve's GLV table) and pe3, both 16-byte aligned; the
// rest as msm_scan
extern "C" int msm_scan_rows_glv(const int32_t* packed, const int32_t* perm,
                                 const int32_t* flags, int32_t* pe3,
                                 int32_t* tx, int32_t* ty, int32_t* tz,
                                 int64_t groups, int C, int R, int curve,
                                 int width, void* stream) {
  MSM_FIELD_SWITCH(curve, ScanGlvLaunch, (packed, perm, flags, pe3, tx, ty, tz,
                                          groups, C, R, width, (cudaStream_t)stream))
}
