// The compressed path's kernels 9, 12 and 13 (12 and 13 also in their GLV
// modes) for Pallas, in a translation unit of their own
// (csrc/dispatch.cuh): the C entries in inv.cu and compress.cu call these
// launches for curve index FpPallas::ID.
#include "pairs.cuh"

MSM_INSTANTIATE_PAIRS(msm::FpPallas)
