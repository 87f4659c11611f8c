// The curve dispatch of the C entries, every kernel being generic over the
// field: the plain path's (kernels 1, 2, 4, 5, 6 and 7), the GLV modes of 2
// and 4, the pair kernels (9-13, with the GLV modes of 10-13), BPR phase 1
// (8) and the scaled modes of 2. Each kernel's launch is a class template
// over the field, LAUNCH<F>::run(...); BN254's is instantiated in the
// kernel's own translation unit, each other curve's in two of its own
// (csrc/curve_*.cu: MSM_INSTANTIATE_PLAIN and MSM_INSTANTIATE_GLV in
// curve_<name>.cu, MSM_INSTANTIATE_PAIRS and MSM_INSTANTIATE_OFFPATH in
// curve_<name>_pairs.cu), so the parallel build spreads them. A C entry takes the curve's index in params.CURVES (F::ID)
// and switches on it; an index without an instantiation is
// cudaErrorInvalidValue. The limb width is not an argument: each width's
// library (ops/_build.py, -DMSM_LIMB_BITS) instantiates the same launches
// over its own traits table (fields.cuh).
#pragma once

#include <cuda_runtime.h>

#include "fields.cuh"

#define MSM_FIELD_SWITCH(curve, LAUNCH, ARGS)                          \
  switch (curve) {                                                     \
    case msm::FpBn254::ID: return msm::LAUNCH<msm::FpBn254>::run ARGS; \
    case msm::FpBls12_377::ID:                                         \
      return msm::LAUNCH<msm::FpBls12_377>::run ARGS;                  \
    case msm::FpPallas::ID: return msm::LAUNCH<msm::FpPallas>::run ARGS; \
    case msm::FpBls12_381::ID:                                         \
      return msm::LAUNCH<msm::FpBls12_381>::run ARGS;                  \
    case msm::FpSecp256k1::ID:                                         \
      return msm::LAUNCH<msm::FpSecp256k1>::run ARGS;                  \
    case msm::FpGrumpkin::ID:                                          \
      return msm::LAUNCH<msm::FpGrumpkin>::run ARGS;                   \
    case msm::FpVesta::ID: return msm::LAUNCH<msm::FpVesta>::run ARGS; \
    default: return (int)cudaErrorInvalidValue;                        \
  }

// In a kernel's translation unit: the six other curves' launches are
// instantiated elsewhere.
#define MSM_EXTERN_OTHER_FIELDS(LAUNCH)                   \
  namespace msm {                                         \
  extern template struct LAUNCH<FpBls12_377>;             \
  extern template struct LAUNCH<FpPallas>;                \
  extern template struct LAUNCH<FpBls12_381>;             \
  extern template struct LAUNCH<FpSecp256k1>;             \
  extern template struct LAUNCH<FpGrumpkin>;              \
  extern template struct LAUNCH<FpVesta>;                 \
  }

// In a curve's translation unit: the plain path's six launches for field F.
#define MSM_INSTANTIATE_PLAIN(F)              \
  namespace msm {                             \
  template struct PointAddLaunch<F>;          \
  template struct ConvertLaunch<F>;           \
  template struct ScanLaunch<F>;              \
  template struct RowOffsetsLaunch<F>;        \
  template struct PointTotalLaunch<F>;        \
  template struct HornerLaunch<F>;            \
  }

// In a curve's translation unit: the GLV modes of the convert and the scan
// for field F.
#define MSM_INSTANTIATE_GLV(F)                \
  namespace msm {                             \
  template struct ConvertGlvLaunch<F>;        \
  template struct ScanGlvLaunch<F>;           \
  }

// In a curve's second translation unit: the pair kernels' launches for
// field F (kernels 9-13; 10-13 in both row layouts).
#define MSM_INSTANTIATE_PAIRS(F)              \
  namespace msm {                             \
  template struct PowLaunch<F>;               \
  template struct PairSuffixLaunch<F>;        \
  template struct EmitScanLaunch<F>;          \
  template struct PairForwardLaunch<F>;       \
  template struct PairBackwardLaunch<F>;      \
  }

// In a curve's second translation unit: the launches no served config runs
// (offpath.cuh) for field F: BPR phase 1 (kernel 8) and the scaled convert.
#define MSM_INSTANTIATE_OFFPATH(F)            \
  namespace msm {                             \
  template struct BprLaunch<F>;               \
  template struct ConvertScaledLaunch<F>;     \
  }
