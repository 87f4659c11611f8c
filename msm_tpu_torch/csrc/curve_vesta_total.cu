// The point total (kernel 6) for Vesta, in a translation unit of its
// own (csrc/dispatch.cuh): the C entry in point_total.cu calls this launch
// for curve index FpVesta::ID.
#include "plain.cuh"

MSM_INSTANTIATE_POINT_TOTAL(msm::FpVesta)
