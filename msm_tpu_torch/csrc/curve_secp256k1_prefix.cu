// The row offsets (kernel 5) for secp256k1, in a translation unit of its
// own (csrc/dispatch.cuh): the C entry in prefix.cu calls this launch for
// curve index FpSecp256k1::ID.
#include "plain.cuh"

MSM_INSTANTIATE_ROW_OFFSETS(msm::FpSecp256k1)
