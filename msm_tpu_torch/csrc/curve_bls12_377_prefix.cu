// The row offsets (kernel 5) for BLS12-377, in a translation unit of its
// own (csrc/dispatch.cuh): the C entry in prefix.cu calls this launch for
// curve index FpBls12_377::ID.
#include "plain.cuh"

MSM_INSTANTIATE_ROW_OFFSETS(msm::FpBls12_377)
