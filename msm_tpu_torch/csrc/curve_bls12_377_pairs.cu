// The compressed path's kernels 9, 12 and 13 (12 and 13 also in their GLV
// modes) for BLS12-377, in a translation unit of their own
// (csrc/dispatch.cuh): the C entries in inv.cu and compress.cu call these
// launches for curve index FpBls12_377::ID.
#include "pairs.cuh"

MSM_INSTANTIATE_PAIRS(msm::FpBls12_377)
