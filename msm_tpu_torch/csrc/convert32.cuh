// Kernel 2 (csrc/convert.cu): the per-point body on the word core.
// __host__ __device__, so the host C++ compiler builds it for the CPU tests;
// the plain mode's kernel and launch (ConvertLaunch<F>) are in plain.cuh.
//
// A coordinate arrives as 2 NW little-endian u16 words (held in int16;
// BN254: 16); read as NW little-endian 32-bit words they are already the
// word core's form. The value may be anything in [0, 2^(32 NW)) (inputs
// are not validated by default), so it is reduced below p first; one
// Montgomery product by R^2 mod p then gives a R mod p, canonical -- the
// packed table's dense words, x then y. Every mode is generic over the
// field (the last template parameter, BN254 by default).
//
// The GLV table (convert_point_glv) has three coordinates a row, x R,
// beta x R and y R: one more product, by beta R^2 mod p (the field's
// F::beta_r2), gives the x of phi(P) = (beta x, y) in Montgomery form from
// the same reduced x.
//
// convert_point_scaled takes the x constants at run time (the JAX
// factory's x_scale_int and dual_x_scale_int, canonical words) and writes
// one of three layouts: one [n, 2D] table, two [n, 2D] tables sharing y,
// or one [n, 3D] table.
#pragma once

#include "fe32.cuh"

namespace msm {

// u16 words per input coordinate (2 NW; BN254: 16)
template <class F>
constexpr int coord_u16 = 2 * F::NW;

// One coordinate's 4 NW bytes (16 B aligned); on the device NW / 4 16-byte
// loads through the read-only cache.
template <class F>
MSM_HD void convert_load(fe32t<F>& a, const int16_t* w) {
#ifdef __CUDA_ARCH__
  const int4* q = reinterpret_cast<const int4*>(w);
  MSM_UNROLL
  for (int k = 0; k < F::NW / 4; ++k) {
    const int4 v = __ldg(q + k);
    a.w[4 * k] = v.x; a.w[4 * k + 1] = v.y; a.w[4 * k + 2] = v.z; a.w[4 * k + 3] = v.w;
  }
#else
  MSM_UNROLL
  for (int k = 0; k < F::NW; ++k)
    a.w[k] = (uint32_t)(uint16_t)w[2 * k] | ((uint32_t)(uint16_t)w[2 * k + 1] << 16);
#endif
}

// NW dense words (16 B aligned); on the device NW / 4 16-byte stores.
template <class F>
MSM_HD void convert_store(int32_t* dst, const fe32t<F>& a) {
#ifdef __CUDA_ARCH__
  int4* q = reinterpret_cast<int4*>(dst);
  MSM_UNROLL
  for (int k = 0; k < F::NW / 4; ++k)
    q[k] = make_int4((int)a.w[4 * k], (int)a.w[4 * k + 1], (int)a.w[4 * k + 2],
                     (int)a.w[4 * k + 3]);
#else
  MSM_UNROLL
  for (int k = 0; k < F::NW; ++k) dst[k] = (int32_t)a.w[k];
#endif
}

// Point i: xw[i], yw[i] ([n, 2 NW] u16 words) -> out[i] = x R || y R
// ([n, 2 NW] dense words, canonical).
template <class F = FpBn254>
MSM_HD void convert_point(const int16_t* xw, const int16_t* yw, int32_t* out,
                          int64_t i) {
  constexpr int NW = F::NW;
  fe32t<F> r2, x, y;
  fe32_const_r2(r2);
  convert_load(x, xw + i * coord_u16<F>);
  convert_load(y, yw + i * coord_u16<F>);
  fe32_reduce_full(x);
  fe32_reduce_full(y);
  fe32_mul(x, x, r2);
  fe32_mul(y, y, r2);
  convert_store(out + i * 2 * NW, x);
  convert_store(out + i * 2 * NW + NW, y);
}

// Point i under GLV: out[i] = x R || beta x R || y R ([n, 3 NW] dense
// words, canonical; rows of 12 NW bytes, 16 B aligned). beta R^2 mod p is
// the field's compiled-in F::beta_r2 (fields.cuh), so a product by it takes
// x to beta x R mod p.
template <class F = FpBn254>
MSM_HD void convert_point_glv(const int16_t* xw, const int16_t* yw,
                              int32_t* out, int64_t i) {
  constexpr int NW = F::NW;
  fe32t<F> r2, br2, x, bx, y;
  fe32_const_r2(r2);
  MSM_UNROLL
  for (int k = 0; k < NW; ++k) br2.w[k] = F::beta_r2(k);
  convert_load(x, xw + i * coord_u16<F>);
  convert_load(y, yw + i * coord_u16<F>);
  fe32_reduce_full(x);
  fe32_reduce_full(y);
  fe32_mul(bx, x, br2);
  fe32_mul(x, x, r2);
  fe32_mul(y, y, r2);
  int32_t* row = out + i * 3 * NW;
  convert_store(row, x);
  convert_store(row + NW, bx);
  convert_store(row + 2 * NW, y);
}

// Output layouts of convert_point_scaled: out [n, 2 NW] rows x xs || y R;
// out, out2 [n, 2 NW] rows x xs || y R and x xs2 || y R; out [n, 3 NW]
// rows x xs || x xs2 || y R.
constexpr int CONVERT_ONE = 0;
constexpr int CONVERT_DUAL = 1;
constexpr int CONVERT_TRIPLE = 2;

// Point i with run-time x constants xs, xs2 (canonical; a product by c
// takes x to x c R^-1 mod p, so c = R^2 gives x R and c = beta R^2 gives
// beta x R); y always enters Montgomery form by R^2. xs2 and out2 are read
// only by the layouts that name them.
template <int LAYOUT, class F = FpBn254>
MSM_HD void convert_point_scaled(const int16_t* xw, const int16_t* yw,
                                 const fe32t<F>& xs, const fe32t<F>& xs2,
                                 int32_t* out, int32_t* out2, int64_t i) {
  constexpr int NW = F::NW;
  fe32t<F> r2, x, y, x1;
  fe32_const_r2(r2);
  convert_load(x, xw + i * coord_u16<F>);
  convert_load(y, yw + i * coord_u16<F>);
  fe32_reduce_full(x);
  fe32_reduce_full(y);
  fe32_mul(x1, x, xs);
  fe32_mul(y, y, r2);
  if constexpr (LAYOUT == CONVERT_TRIPLE) {
    fe32t<F> x2;
    fe32_mul(x2, x, xs2);
    int32_t* row = out + i * 3 * NW;
    convert_store(row, x1);
    convert_store(row + NW, x2);
    convert_store(row + 2 * NW, y);
  } else {
    convert_store(out + i * 2 * NW, x1);
    convert_store(out + i * 2 * NW + NW, y);
    if constexpr (LAYOUT == CONVERT_DUAL) {
      fe32t<F> x2;
      fe32_mul(x2, x, xs2);
      convert_store(out2 + i * 2 * NW, x2);
      convert_store(out2 + i * 2 * NW + NW, y);
    }
  }
}

}  // namespace msm
