// Batched-affine pair compression of the sorted stream: the four pair
// kernels, one thread per (subtask, lane) chain, all on the word core: the
// shared pair algebra and the per-lane bodies of the forward products, the
// backward emission and the suffix products in pair32.cuh, the fused
// emission + scan in emit_scan.cuh. The suffix products and the emission +
// scan (the compressed MSM's kernels 12 and 13), the forward products and
// the backward emission (kernels 10 and 11, compress_pairs) are generic
// over the field: their kernels and launches are in pairs.cuh
// (PairSuffixLaunch<F>, EmitScanLaunch<F>, PairForwardLaunch<F>,
// PairBackwardLaunch<F>), BN254's instantiated here and each other curve's
// in csrc/curve_<name>_pairs.cu, and every C entry dispatches on the curve.
//
// Replaces, in msm_tpu/ops/pallas_compress.py: make_pair_suffix (pallas_call
// at :427), make_emit_scan (:561), make_pair_forward (:205) and
// make_pair_backward (:333), together with the sorted-order gather that fed
// them (msm_tpu/ops/scan.py:349): each kernel gathers its own packed rows.
// The TPU walked the chain along a sequential grid axis with the running
// value in VMEM scratch; here a thread walks its lane's Cp pairs with the
// running value in registers.
//
// GLV modes (the TPU kernels' _load_pair_point, pallas_compress.py:122-140):
// k_pair_forward_glv, k_pair_backward_glv, k_pair_suffix_glv and
// k_emit_scan_glv are the same bodies over the GLV table's rows x, beta x,
// y (COORDS = 3 in pair32.cuh and emit_scan.cuh): an element's x is the
// half bit 1 of its flags names.
//
// Bound: Montgomery products per pair, in series along each lane's chain
// (suffix and forward 1, backward 5, emit+scan 5 + the 11 of the mixed add,
// and one more for a doubling), plus two 64 B random gathers per pair. A
// chain's steps are serial, so a launch fills the card only with enough
// chains: the compressed geometry (models/geometry.py) gives G x R = 16 x
// 2048 chains per launch at 2^20 (the TPU's rule gave 4 x 1024).
// Every kernel runs 128 threads a block with __launch_bounds__(128,
// F::BLOCKS_PER_SM) (4 at 8 words, 2 at the BLS12 curves' 12), as the scan
// kernel (csrc/scan.cu): the word core inlined, the chain values in
// registers. With few chains (4 x 1024 at the TPU rule's shape, 32
// blocks) each block's four warps sit on the four schedulers of one SM,
// which gives a chain the issue rate a warp alone on an SM would.
//   - k_emit_scan (emit_scan.cuh): the accumulator and the inverse chain
//     in registers. The inverse chain's two products (inv(d_j), t_{j+1})
//     do not wait on the accumulator, so their latency overlaps the mixed
//     add's. From 8 warps per SM on (16 x 2048 chains), more chains no
//     longer shorten the launch (scripts/torch_compress_geometry.py); the
//     launch-plan and prefetch variants are in
//     scripts/torch_emit_scan_variants.py (PERF.md).
//   - k_pair_suffix and k_pair_forward (pair32.cuh): one product a pair,
//     so a step lasts as long as its gathers unless they are hidden: only
//     the x coordinates gathered (y where x1 == x2), half the bytes of full
//     rows; the next pair's gathers issued before this pair's product.
//     Deeper pipelines, streaming stores, full-row gathers, a chain split
//     over 2 or 4 threads (two passes, the segment offsets combined in
//     shared memory) and the 13-bit suffix kernel this one replaced are
//     timed against each other by scripts/torch_suffix_pow_variants.py
//     (PERF.md). The output keeps the 13-bit limb layout kernels 9, 11 and
//     13 read: at 2^20 that is 671 MB of s (80 B an element) where words
//     would be 268 MB.
//   - k_pair_backward (pair32.cuh): the full rows of a pair (the emission
//     needs both y), m_{j-1} read as canonical limbs, then the products.
#include <cuda_runtime.h>

#include "pairs.cuh"

using namespace msm;

MSM_EXTERN_OTHER_FIELDS(PairSuffixLaunch)
MSM_EXTERN_OTHER_FIELDS(EmitScanLaunch)
MSM_EXTERN_OTHER_FIELDS(PairForwardLaunch)
MSM_EXTERN_OTHER_FIELDS(PairBackwardLaunch)

// packed [N, 2D] 16-byte aligned, D the curve's words per coordinate;
// perm, flags [G, 2 Cp, R]; s [G, Cp, L, R]
extern "C" int msm_pair_suffix(const int32_t* packed, const int32_t* perm,
                               const int32_t* flags, int32_t* s,
                               int64_t groups, int Cp, int R, int curve,
                               int width, void* stream) {
  MSM_FIELD_SWITCH(curve, PairSuffixLaunch, (packed, perm, flags, s, groups,
                                             Cp, R, 2, width, (cudaStream_t)stream))
}

// ... s [G, Cp, L, R] canonical; t0 [G, L, R]; pe3 [G, Cp, R, P] (P the
// curve's pe3 row: 3L limbs padded to a multiple of 4, scan.cuh pe3_row);
// t* [G, L, R]; packed and pe3 16-byte aligned
extern "C" int msm_emit_scan(const int32_t* packed, const int32_t* perm,
                             const int32_t* flags, const int32_t* s,
                             const int32_t* t0, int32_t* pe3, int32_t* tx,
                             int32_t* ty, int32_t* tz, int64_t groups, int Cp,
                             int R, int curve, int width, void* stream) {
  MSM_FIELD_SWITCH(curve, EmitScanLaunch,
                   (packed, perm, flags, s, t0, pe3, tx, ty, tz, groups, Cp, R,
                    2, width, (cudaStream_t)stream))
}

// The GLV modes: packed [N, 3D] (the GLV table); the rest as
// msm_pair_suffix and msm_emit_scan.
extern "C" int msm_pair_suffix_glv(const int32_t* packed, const int32_t* perm,
                                   const int32_t* flags, int32_t* s,
                                   int64_t groups, int Cp, int R, int curve,
                                   int width, void* stream) {
  MSM_FIELD_SWITCH(curve, PairSuffixLaunch, (packed, perm, flags, s, groups,
                                             Cp, R, 3, width, (cudaStream_t)stream))
}

extern "C" int msm_emit_scan_glv(const int32_t* packed, const int32_t* perm,
                                 const int32_t* flags, const int32_t* s,
                                 const int32_t* t0, int32_t* pe3, int32_t* tx,
                                 int32_t* ty, int32_t* tz, int64_t groups,
                                 int Cp, int R, int curve, int width, void* stream) {
  MSM_FIELD_SWITCH(curve, EmitScanLaunch,
                   (packed, perm, flags, s, t0, pe3, tx, ty, tz, groups, Cp, R,
                    3, width, (cudaStream_t)stream))
}

// Kernels 10 and 11: the forward products and the backward emission
// (compress_pairs).

// ... m [G, Cp, L, R]; packed 16-byte aligned
extern "C" int msm_pair_forward(const int32_t* packed, const int32_t* perm,
                                const int32_t* flags, int32_t* m,
                                int64_t groups, int Cp, int R, int curve,
                                int width, void* stream) {
  MSM_FIELD_SWITCH(curve, PairForwardLaunch, (packed, perm, flags, m, groups,
                                              Cp, R, 2, width, (cudaStream_t)stream))
}

// ... m [G, Cp, L, R] canonical; minv [G, L, R]; cx, cy [G, Cp, L, R];
// inf [G, Cp, R]; packed 16-byte aligned
extern "C" int msm_pair_backward(const int32_t* packed, const int32_t* perm,
                                 const int32_t* flags, const int32_t* m,
                                 const int32_t* minv, int32_t* cx, int32_t* cy,
                                 int32_t* inf, int64_t groups, int Cp, int R,
                                 int curve, int width, void* stream) {
  MSM_FIELD_SWITCH(curve, PairBackwardLaunch,
                   (packed, perm, flags, m, minv, cx, cy, inf, groups, Cp, R,
                    2, width, (cudaStream_t)stream))
}

// The GLV modes of kernels 10 and 11: packed [N, 3D] (the GLV table); the
// rest as msm_pair_forward and msm_pair_backward.
extern "C" int msm_pair_forward_glv(const int32_t* packed, const int32_t* perm,
                                    const int32_t* flags, int32_t* m,
                                    int64_t groups, int Cp, int R, int curve,
                                    int width, void* stream) {
  MSM_FIELD_SWITCH(curve, PairForwardLaunch, (packed, perm, flags, m, groups,
                                              Cp, R, 3, width, (cudaStream_t)stream))
}

extern "C" int msm_pair_backward_glv(const int32_t* packed,
                                     const int32_t* perm,
                                     const int32_t* flags, const int32_t* m,
                                     const int32_t* minv, int32_t* cx,
                                     int32_t* cy, int32_t* inf, int64_t groups,
                                     int Cp, int R, int curve, int width, void* stream) {
  MSM_FIELD_SWITCH(curve, PairBackwardLaunch,
                   (packed, perm, flags, m, minv, cx, cy, inf, groups, Cp, R,
                    3, width, (cudaStream_t)stream))
}
