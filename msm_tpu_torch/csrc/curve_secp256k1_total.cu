// The point total (kernel 6) for secp256k1, in a translation unit of its
// own (csrc/dispatch.cuh): the C entry in point_total.cu calls this launch
// for curve index FpSecp256k1::ID.
#include "plain.cuh"

MSM_INSTANTIATE_POINT_TOTAL(msm::FpSecp256k1)
