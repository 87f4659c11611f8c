// The row offsets (kernel 5) for Vesta, in a translation unit of its
// own (csrc/dispatch.cuh): the C entry in prefix.cu calls this launch for
// curve index FpVesta::ID.
#include "plain.cuh"

MSM_INSTANTIATE_ROW_OFFSETS(msm::FpVesta)
