// The plain path's kernels 1, 2, 4 and 7, and the GLV modes of 2 and 4, for
// BLS12-377, in a translation unit of their own (csrc/dispatch.cuh): the C
// entries in point_add.cu, convert.cu, scan.cu and horner.cu call these
// launches for curve index FpBls12_377::ID. Its row offsets (kernel 5) are in
// curve_bls12_377_prefix.cu, its point total (6) in curve_bls12_377_total.cu, its
// pair kernels, BPR phase 1 and scaled convert in curve_bls12_377_pairs.cu.
#include "plain.cuh"

MSM_INSTANTIATE_PLAIN(msm::FpBls12_377)
MSM_INSTANTIATE_GLV(msm::FpBls12_377)
