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
// since a canonical value has one encoding. Every kernel is generic over
// the field (plain.cuh: ConvertLaunch<F>, ConvertGlvLaunch<F>; offpath.cuh:
// ConvertScaledLaunch<F>; BN254's instances here, each other curve's in
// csrc/curve_<name>.cu, the scaled one in csrc/curve_<name>_pairs.cu);
// every C entry dispatches on the curve.
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

#include "offpath.cuh"

using namespace msm;

MSM_EXTERN_OTHER_FIELDS(ConvertLaunch)
MSM_EXTERN_OTHER_FIELDS(ConvertGlvLaunch)
MSM_EXTERN_OTHER_FIELDS(ConvertScaledLaunch)

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

// xw, yw [n, 2D] int16 (u16 bits); xs, xs2: HOST pointers to the x
// constants' D canonical words (xs2 read only by the two-table and triple
// layouts, may be null otherwise); layout CONVERT_ONE (out [n, 2D]),
// CONVERT_DUAL (out, out2 [n, 2D]) or CONVERT_TRIPLE (out [n, 3D]); the
// device arrays 16-byte aligned
extern "C" int msm_convert_scaled(const int16_t* xw, const int16_t* yw,
                                  const uint32_t* xs, const uint32_t* xs2,
                                  int32_t* out, int32_t* out2, int64_t n,
                                  int layout, int curve, void* stream) {
  MSM_FIELD_SWITCH(curve, ConvertScaledLaunch,
                   (xw, yw, xs, xs2, out, out2, n, layout,
                    (cudaStream_t)stream))
}
