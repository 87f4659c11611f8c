// The kernels that no served config runs, and their launches, generic over
// the field: BPR phase 1 (kernel 8, k_bpr_phase1: the blocked bucket
// reduction's first phase; body bpr.cuh) and the convert with its x
// constants given at run time (kernel 2's scaled modes, k_convert_scaled;
// body convert32.cuh). nvcc only. Each launch is a class template LAUNCH<F>
// with one static run(...); BN254's is instantiated in bpr.cu and
// convert.cu, each other curve's in csrc/curve_<name>_pairs.cu
// (MSM_INSTANTIATE_OFFPATH), and the C entries dispatch on the curve
// (dispatch.cuh). The design notes are in bpr.cu and convert.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bpr.cuh"
#include "plain.cuh"

namespace msm {

// ---- Kernel 8, BPR phase 1 (body: bpr.cuh) ----
constexpr int BPR_LANES = 4, BPR_THREADS = 256;
constexpr int BPR_CHAINS = BPR_THREADS / BPR_LANES;  // chains per block

// One 256-thread block an SM at either word count (no minimum in the
// bound): the word core's budget of F::BLOCKS_PER_SM 128-thread blocks
// (512 threads at 8 words) would cap the 8-word chain at 128 registers,
// below the 168 it holds; at 12 words it is this block alone anyway.
template <class F>
__global__ void __launch_bounds__(BPR_THREADS)
    k_bpr_phase1(const int32_t* __restrict__ bx, const int32_t* __restrict__ by,
                 const int32_t* __restrict__ bz, int32_t* __restrict__ mx,
                 int32_t* __restrict__ my, int32_t* __restrict__ mz,
                 int32_t* __restrict__ gx, int32_t* __restrict__ gy,
                 int32_t* __restrict__ gz, int Bl, int T) {
  const int t = blockIdx.x * BPR_CHAINS + threadIdx.x / BPR_LANES;
  bpr_phase1_chain<BPR_LANES, F>(bx, by, bz, mx, my, mz, gx, gy, gz,
                                 blockIdx.y, Bl, T, t < T ? t : T - 1, t < T);
}

template <class F>
struct BprLaunch {
  static int run(const int32_t* bx, const int32_t* by, const int32_t* bz,
                 int32_t* mx, int32_t* my, int32_t* mz, int32_t* gx,
                 int32_t* gy, int32_t* gz, int64_t groups, int Bl, int T,
                 cudaStream_t st);
};

// b* [G, Bl, T, L]; m*, g* [G, T, L]; every pointer row_align<L> aligned
template <class F>
int BprLaunch<F>::run(const int32_t* bx, const int32_t* by, const int32_t* bz,
                      int32_t* mx, int32_t* my, int32_t* mz, int32_t* gx,
                      int32_t* gy, int32_t* gz, int64_t groups, int Bl, int T,
                      cudaStream_t st) {
  const uintptr_t addr = (uintptr_t)bx | (uintptr_t)by | (uintptr_t)bz |
                         (uintptr_t)mx | (uintptr_t)my | (uintptr_t)mz |
                         (uintptr_t)gx | (uintptr_t)gy | (uintptr_t)gz;
  if (addr % row_align<F::L>) return (int)cudaErrorInvalidValue;
  if (groups > 0 && Bl > 0 && T > 0) {
    const dim3 grid((unsigned)((T + BPR_CHAINS - 1) / BPR_CHAINS),
                    (unsigned)groups);
    k_bpr_phase1<F><<<grid, BPR_THREADS, 0, st>>>(bx, by, bz, mx, my, mz, gx,
                                                  gy, gz, Bl, T);
  }
  return (int)cudaGetLastError();
}

// ---- Kernel 2, the convert, scaled modes (body: convert32.cuh) ----

template <class F, int LAYOUT>
__global__ void __launch_bounds__(CONVERT_THREADS)
    k_convert_scaled(const int16_t* __restrict__ xw,
                     const int16_t* __restrict__ yw, const fe32t<F> xs,
                     const fe32t<F> xs2, int32_t* __restrict__ out,
                     int32_t* __restrict__ out2, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    convert_point_scaled<LAYOUT, F>(xw, yw, xs, xs2, out, out2, i);
}

template <class F>
struct ConvertScaledLaunch {
  static int run(const int16_t* xw, const int16_t* yw, const uint32_t* xs,
                 const uint32_t* xs2, int32_t* out, int32_t* out2, int64_t n,
                 int layout, cudaStream_t st);
};

// xw, yw [n, 2 NW] int16 (u16 bits); xs, xs2: HOST pointers to the x
// constants' NW canonical words (xs2 read only by the two-table and triple
// layouts, may be null otherwise); layout CONVERT_ONE (out [n, 2 NW]),
// CONVERT_DUAL (out, out2 [n, 2 NW]) or CONVERT_TRIPLE (out [n, 3 NW]);
// the device arrays 16-byte aligned
template <class F>
int ConvertScaledLaunch<F>::run(const int16_t* xw, const int16_t* yw,
                                const uint32_t* xs, const uint32_t* xs2,
                                int32_t* out, int32_t* out2, int64_t n,
                                int layout, cudaStream_t st) {
  const bool two = layout == CONVERT_DUAL;
  if (layout < CONVERT_ONE || layout > CONVERT_TRIPLE || !xs ||
      (layout != CONVERT_ONE && !xs2) || (two && !out2))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)xw | (uintptr_t)yw | (uintptr_t)out |
       (two ? (uintptr_t)out2 : 0)) % 16)
    return (int)cudaErrorInvalidValue;
  fe32t<F> a, b;
  for (int k = 0; k < F::NW; ++k) {
    a.w[k] = xs[k];
    b.w[k] = xs2 ? xs2[k] : 0u;
  }
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + CONVERT_THREADS - 1) / CONVERT_THREADS);
    if (layout == CONVERT_ONE)
      k_convert_scaled<F, CONVERT_ONE><<<blocks, CONVERT_THREADS, 0, st>>>(
          xw, yw, a, b, out, out2, n);
    else if (two)
      k_convert_scaled<F, CONVERT_DUAL><<<blocks, CONVERT_THREADS, 0, st>>>(
          xw, yw, a, b, out, out2, n);
    else
      k_convert_scaled<F, CONVERT_TRIPLE><<<blocks, CONVERT_THREADS, 0, st>>>(
          xw, yw, a, b, out, out2, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace msm
