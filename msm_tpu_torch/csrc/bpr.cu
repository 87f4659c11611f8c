// Kernel 8: phase 1 of the blocked bucket reduction, one thread per
// (subtask, lane). The per-lane body is in bpr.cuh.
//
// Replaces msm_tpu/ops/pallas_bpr.py::make_bpr_phase1 (pallas_call at :97).
// The TPU kept (m, g) in VMEM scratch across the sequential grid axis of Bl
// steps and read the buckets descending through its index map; here a
// thread keeps them in registers and its loop index runs backwards. Nothing
// crosses threads. The input stays step-major [G, Bl, T, L], so at every
// step neighbouring threads read neighbouring 80-byte rows.
//
// Bound: integer multiply-adds, 2 * Bl dependent complete additions (12
// Montgomery products each) per lane, in series. At the 2^20 shape there are
// only G * T = 16 * 512 lanes, so the design is latency-bound: blocks are one
// warp wide to spread the lanes over as many of the 132 SMs as possible.
#include <cuda_runtime.h>

#include "bpr.cuh"

using namespace msm;

constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
    k_bpr_phase1(const int32_t* __restrict__ bx, const int32_t* __restrict__ by,
                 const int32_t* __restrict__ bz, int32_t* __restrict__ mx,
                 int32_t* __restrict__ my, int32_t* __restrict__ mz,
                 int32_t* __restrict__ gx, int32_t* __restrict__ gy,
                 int32_t* __restrict__ gz, int Bl, int T) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < T)
    bpr_phase1_lane(bx, by, bz, mx, my, mz, gx, gy, gz, blockIdx.y, Bl, T, t);
}

// b* [G, Bl, T, L]; m*, g* [G, T, L]
extern "C" int msm_bpr_phase1(const int32_t* bx, const int32_t* by,
                              const int32_t* bz, int32_t* mx, int32_t* my,
                              int32_t* mz, int32_t* gx, int32_t* gy,
                              int32_t* gz, int64_t groups, int Bl, int T,
                              void* stream) {
  if (groups > 0 && Bl > 0 && T > 0) {
    const dim3 grid((unsigned)((T + THREADS - 1) / THREADS), (unsigned)groups);
    k_bpr_phase1<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        bx, by, bz, mx, my, mz, gx, gy, gz, Bl, T);
  }
  return (int)cudaGetLastError();
}
