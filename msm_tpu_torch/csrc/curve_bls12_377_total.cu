// The point total (kernel 6) for BLS12-377, in a translation unit of its
// own (csrc/dispatch.cuh): the C entry in point_total.cu calls this launch
// for curve index FpBls12_377::ID.
#include "plain.cuh"

MSM_INSTANTIATE_POINT_TOTAL(msm::FpBls12_377)
