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
// cudaErrorInvalidValue. Every C entry also takes the limb width after
// the curve, and each launch opens a WidthScope<F> with it: in the default
// library (13-bit traits at compile time) any other width is
// cudaErrorInvalidValue; in the narrow library (-DMSM_LIMB_BITS=0,
// ops/_build.py) the scope makes the (curve, width) row of widths.cuh the
// curve's width block in this translation unit's constant memory (the
// copy its kernels read), on the launch's stream, when the device's copy
// holds another width, and holds a lock until the launch is enqueued. A
// width change of one curve is thus ordered behind the earlier launches
// of its stream. A launch on another stream than the one that loaded the
// block first waits for the device (the other stream's launches may still
// read the block, and its copy may not have run yet), then loads the block
// if its width differs: any mix of streams and widths reads the right
// block, and the port's one stream a device (torch's current stream) never
// waits.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

#include "fields.cuh"

namespace msm {

#if MSM_NARROW
// The width whose block a device's constant copy holds for a curve (0:
// none yet) and the stream that loaded it
struct WidthLoaded {
  int width;
  cudaStream_t stream;
};

// This translation unit's lock and loaded blocks, for the first 64 devices
// (a device above is cudaErrorInvalidDevice)
static std::mutex width_lock;
static WidthLoaded width_loaded[64][WIDTH_CURVES];

template <class F>
struct WidthScope {
  std::lock_guard<std::mutex> hold;
  int err = 0;
  WidthScope(int width, cudaStream_t st) : hold(width_lock) {
    if (width < WIDTH_MIN || width > WIDTH_MAX) {
      err = (int)cudaErrorInvalidValue;
      return;
    }
    int dev = 0;
    if ((err = (int)cudaGetDevice(&dev))) return;
    if (dev >= 64) {
      err = (int)cudaErrorInvalidDevice;
      return;
    }
    WidthLoaded& loaded = width_loaded[dev][F::ID];
    if (loaded.width == width && loaded.stream == st) return;
    if (loaded.width && loaded.stream != st && (err = (int)cudaDeviceSynchronize())) return;
    if (loaded.width != width &&
        (err = (int)cudaMemcpyToSymbolAsync(width_dev, &WIDTH_BLOCKS[F::ID][width - WIDTH_MIN], sizeof(WidthBlock),
                                            F::ID * sizeof(WidthBlock), cudaMemcpyHostToDevice, st)))
      return;
    loaded = {width, st};
  }
};
#else
template <class F>
struct WidthScope {
  int err;
  WidthScope(int width, cudaStream_t) : err(width == F::W ? 0 : (int)cudaErrorInvalidValue) {}
};
#endif

}  // namespace msm

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
