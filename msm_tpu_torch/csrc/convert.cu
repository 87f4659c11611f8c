// Point conversion: 16-bit coordinate words -> canonical Montgomery form
// (one product by R^2) -> the packed table's dense radix-2^32 words.
//
// Replaces: msm_tpu/ops/pallas_convert.py::make_convert_pack (pallas_call
// at :187), in all its modes: k_convert the plain one, [n, 2D] rows (D = 8
// words per BN254 coordinate, 12 per BLS12 one, x words then y words);
// k_convert_glv the GLV one (dual_x_scale_int = beta R^2, triple=True,
// :101-145), [n, 3D] rows x, beta x, y; k_convert_scaled<LAYOUT> every mode
// with its x constants at run time (x_scale_int, dual_x_scale_int; one
// [n, 2D] table, two, or one [n, 3D]), the first two with their constants
// compiled in (the field's R^2 and beta R^2, fields.cuh). Bit for bit,
// since a canonical value has one encoding. The plain and GLV kernels are
// generic over the field (plain.cuh: ConvertLaunch<F>, ConvertGlvLaunch<F>;
// BN254's instances here, each other curve's in csrc/curve_<name>.cu);
// msm_convert and msm_convert_glv dispatch on the curve. The scaled kernel
// is BN254's.
//
// Bound: bytes. Each point reads 64 B (two coordinates of 16 u16 words,
// int16 on the wire) and writes 64 B, against 2 Montgomery products; at
// 2^20 points the 128 MiB moved and the 2^21 products take about the same
// least time (~0.04 ms). The design (csrc/convert32.cuh): the word core,
// on which little-endian u16 words already are the 32-bit words of a
// coordinate -- no unpacking into 13-bit limbs and no repacking -- with
// two 16-byte loads and two 16-byte stores per coordinate, a reduction
// below p by three conditional subtracts, and one fe32_mul by R^2 mod p.
// One thread per point, so its two products are independent. The GLV mode
// writes 96 B a point against its 3 products (~0.05 ms at 2^20, set by
// the products). The scaled kernel's layouts: one table as k_convert, two
// tables 128 B a point against 3 products (bytes), three coordinates as
// k_convert_glv.
#include <cuda_runtime.h>

#include "plain.cuh"

using namespace msm;

MSM_EXTERN_OTHER_FIELDS(ConvertLaunch)
MSM_EXTERN_OTHER_FIELDS(ConvertGlvLaunch)

constexpr int THREADS = CONVERT_THREADS;

// xw, yw [n, 2D] int16 (u16 bits); out [n, 2D] int32, D the curve's words
// per coordinate; all 16-byte aligned
extern "C" int msm_convert(const int16_t* xw, const int16_t* yw, int32_t* out,
                           int64_t n, int curve, void* stream) {
  MSM_FIELD_SWITCH(curve, ConvertLaunch, (xw, yw, out, n, (cudaStream_t)stream))
}

// xw, yw [n, 2D] int16 (u16 bits); out [n, 3D] int32 (rows x R, beta x R,
// y R), D the curve's words per coordinate; all 16-byte aligned
extern "C" int msm_convert_glv(const int16_t* xw, const int16_t* yw,
                               int32_t* out, int64_t n, int curve,
                               void* stream) {
  MSM_FIELD_SWITCH(curve, ConvertGlvLaunch,
                   (xw, yw, out, n, (cudaStream_t)stream))
}

template <int LAYOUT>
__global__ void __launch_bounds__(THREADS)
    k_convert_scaled(const int16_t* __restrict__ xw,
                     const int16_t* __restrict__ yw, const fe32 xs,
                     const fe32 xs2, int32_t* __restrict__ out,
                     int32_t* __restrict__ out2, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) convert_point_scaled<LAYOUT>(xw, yw, xs, xs2, out, out2, i);
}

// xw, yw [n, 16] int16 (u16 bits); xs, xs2: HOST pointers to the x
// constants' NW canonical words (xs2 read only by the two-table and triple
// layouts, may be null otherwise); layout CONVERT_ONE (out [n, 2D]),
// CONVERT_DUAL (out, out2 [n, 2D]) or CONVERT_TRIPLE (out [n, 3D]); the
// device arrays 16-byte aligned
extern "C" int msm_convert_scaled(const int16_t* xw, const int16_t* yw,
                                  const uint32_t* xs, const uint32_t* xs2,
                                  int32_t* out, int32_t* out2, int64_t n,
                                  int layout, void* stream) {
  const bool two = layout == CONVERT_DUAL;
  if (layout < CONVERT_ONE || layout > CONVERT_TRIPLE || !xs ||
      (layout != CONVERT_ONE && !xs2) || (two && !out2))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)xw | (uintptr_t)yw | (uintptr_t)out |
       (two ? (uintptr_t)out2 : 0)) % 16)
    return (int)cudaErrorInvalidValue;
  fe32 a, b;
  for (int k = 0; k < NW; ++k) {
    a.w[k] = xs[k];
    b.w[k] = xs2 ? xs2[k] : 0u;
  }
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (layout == CONVERT_ONE)
      k_convert_scaled<CONVERT_ONE><<<blocks, THREADS, 0, st>>>(xw, yw, a, b,
                                                               out, out2, n);
    else if (two)
      k_convert_scaled<CONVERT_DUAL><<<blocks, THREADS, 0, st>>>(xw, yw, a, b,
                                                                out, out2, n);
    else
      k_convert_scaled<CONVERT_TRIPLE><<<blocks, THREADS, 0, st>>>(
          xw, yw, a, b, out, out2, n);
  }
  return (int)cudaGetLastError();
}
