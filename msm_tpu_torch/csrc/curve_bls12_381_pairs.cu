// The pair kernels 9-13 (10-13 also in their GLV modes), BPR phase 1
// (kernel 8) and the scaled convert (kernel 2's run-time constants) for
// BLS12-381, in a translation unit of their own (csrc/dispatch.cuh): the C
// entries in inv.cu, compress.cu, bpr.cu and convert.cu call these launches
// for curve index FpBls12_381::ID.
#include "offpath.cuh"
#include "pairs.cuh"

MSM_INSTANTIATE_PAIRS(msm::FpBls12_381)
MSM_INSTANTIATE_OFFPATH(msm::FpBls12_381)
