// The point total (kernel 6) for BLS12-381, in a translation unit of its
// own (csrc/dispatch.cuh): the C entry in point_total.cu calls this launch
// for curve index FpBls12_381::ID.
#include "plain.cuh"

MSM_INSTANTIATE_POINT_TOTAL(msm::FpBls12_381)
