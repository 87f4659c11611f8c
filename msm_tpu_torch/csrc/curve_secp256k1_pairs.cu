// The pair kernels 9-13 (10-13 also in their GLV modes), BPR phase 1
// (kernel 8) and the scaled convert (kernel 2's run-time constants) for
// secp256k1, in a translation unit of their own (csrc/dispatch.cuh): the C
// entries in inv.cu, compress.cu, bpr.cu and convert.cu call these launches
// for curve index FpSecp256k1::ID.
#include "offpath.cuh"
#include "pairs.cuh"

MSM_INSTANTIATE_PAIRS(msm::FpSecp256k1)
MSM_INSTANTIATE_OFFPATH(msm::FpSecp256k1)
