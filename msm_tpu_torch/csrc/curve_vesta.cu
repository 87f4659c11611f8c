// The plain path's kernels 1, 2, 4 and 7, and the GLV modes of 2 and 4, for
// Vesta, in a translation unit of their own (csrc/dispatch.cuh): the C
// entries in point_add.cu, convert.cu, scan.cu and horner.cu call these
// launches for curve index FpVesta::ID. Its row offsets (kernel 5) are in
// curve_vesta_prefix.cu, its point total (6) in curve_vesta_total.cu, its
// pair kernels, BPR phase 1 and scaled convert in curve_vesta_pairs.cu.
#include "plain.cuh"

MSM_INSTANTIATE_PLAIN(msm::FpVesta)
MSM_INSTANTIATE_GLV(msm::FpVesta)
