// The pair kernels 9-13 (10-13 also in their GLV modes), BPR phase 1
// (kernel 8) and the scaled convert (kernel 2's run-time constants) for
// Grumpkin, in a translation unit of their own (csrc/dispatch.cuh): the C
// entries in inv.cu, compress.cu, bpr.cu and convert.cu call these launches
// for curve index FpGrumpkin::ID.
#include "offpath.cuh"
#include "pairs.cuh"

MSM_INSTANTIATE_PAIRS(msm::FpGrumpkin)
MSM_INSTANTIATE_OFFPATH(msm::FpGrumpkin)
