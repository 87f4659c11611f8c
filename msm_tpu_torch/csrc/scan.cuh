// Kernel 4 (csrc/scan.cu): the per-lane body on the word core, generic over
// the field. __host__ __device__, so the host C++ compiler builds it for the
// CPU tests; the plain mode's kernel and launch (ScanLaunch<F>) are in
// plain.cuh (and the GLV mode's, COORDS = 3, ScanGlvLaunch<F>).
//
// Lane r of subtask g walks its C steps: step c folds in table row
// perm[g, c, r] (y negated when flags[g, c, r] & 1) with RCB16 Algorithm 8
// and writes the running sum as one pe3[g, c, r] row x || y || z of
// canonical W-bit limbs [3L]; the sum after the last step goes to the lane
// totals t{x,y,z}[g, :, r], limbs-first.
//
// The table's row layout is a compile-time parameter COORDS of the loads:
// 2, rows x R || y R; or 3, the GLV table's rows x R || beta x R || y R
// (csrc/convert32.cuh convert_point_glv), where an element takes the x of
// the half that bit 1 of its flags names (0: P, 1: phi(P) = (beta x, y))
// and y from the third. Bit 0 of the flags stays the sign of y.
#pragma once

#include "curve32.cuh"

namespace msm {

// The x half of an element of a COORDS-coordinate table, from its flags
// (read only for the GLV layout).
template <int COORDS>
MSM_HD int row_x_half(const int32_t* flag) {
  if constexpr (COORDS == 3) {
    return (*flag >> 1) & 1;
  } else {
    return 0;
  }
}

// One coordinate (half 0 .. COORDS - 1) of table row `row` of packed
// [N, COORDS NW]: 4 NW bytes; on the device NW / 4 16-byte loads through
// the read-only cache (rows are a multiple of 16 B).
template <int COORDS = 2, class F>
MSM_HD void scan_load_coord(fe32t<F>& c, const int32_t* packed, int64_t row,
                            int half) {
  const int32_t* src = packed + (row * COORDS + half) * F::NW;
#ifdef __CUDA_ARCH__
  const int4* q = reinterpret_cast<const int4*>(src);
  MSM_UNROLL
  for (int k = 0; k < F::NW / 4; ++k) {
    const int4 a = __ldg(q + k);
    c.w[4 * k] = a.x; c.w[4 * k + 1] = a.y; c.w[4 * k + 2] = a.z; c.w[4 * k + 3] = a.w;
  }
#else
  fe32_load_dense(c, src);
#endif
}

// An element's x and y from table row `row` of packed [N, COORDS NW], its
// flags at `flag` choosing the x half of a GLV row.
template <int COORDS, class F>
MSM_HD void scan_load_element(fe32t<F>& x, fe32t<F>& y, const int32_t* packed,
                              int64_t row, const int32_t* flag) {
  scan_load_coord<COORDS>(x, packed, row, row_x_half<COORDS>(flag));
  scan_load_coord<COORDS>(y, packed, row, COORDS - 1);
}

// Limbs of one pe3 row: x || y || z (3L) padded with zeros to a multiple
// of 4, so that every row is 16-byte aligned and written with 16-byte
// stores (BN254's 60 as they are; 63 -> 64 at 21 limbs, 90 -> 92 at 30).
template <class F>
constexpr int pe3_row = (3 * F::L + 3) / 4 * 4;

// pe3_row<F> as a value: the width block's PE3_ROW in the narrow build.
template <class F>
MSM_HD int pe3_row_limbs() {
  if constexpr (F::RT) {
    return width_block(F::ID).PE3_ROW;
  } else {
    return pe3_row<F>;
  }
}

// One pe3 row (pe3_row<F> limbs; BN254: 240 B, 16 B aligned); on the
// device 16-byte stores (BN254: 15).
template <class F>
MSM_HD void scan_store_row(int32_t* dst, const pt32t<F>& p) {
  if constexpr (F::RT) {  // x || y || z || zeros in 16-byte stores
    RowLimbs4 row{dst};
    rt_scatter(row, p.x);
    rt_scatter(row, p.y);
    rt_scatter(row, p.z);
    row.pad();
  } else {
    constexpr int L = F::L;
    uint32_t v[pe3_row<F>];
    fe32_to_limbs(v, p.x);
    fe32_to_limbs(v + L, p.y);
    fe32_to_limbs(v + 2 * L, p.z);
    MSM_UNROLL
    for (int k = 3 * L; k < pe3_row<F>; ++k) v[k] = 0;
    row_store(dst, v);
  }
}

// y <- p - y where neg, else y (branch-free; 0 stays 0).
template <class F>
MSM_HD void fe32_cond_neg(fe32t<F>& y, int neg) {
  fe32t<F> n;
  fe32_neg(n, y);
  const uint32_t sel = 0u - (uint32_t)(neg != 0);
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) y.w[i] = (n.w[i] & sel) | (y.w[i] & ~sel);
}

// packed [N, COORDS NW]; perm, flags [G, C, R]; pe3 [G, C, R, pe3_row<F>]
// (3L limbs and the padding); t* [G, L, R].
template <int COORDS = 2, class F = FpBn254>
MSM_HD void scan_lane(const int32_t* packed, const int32_t* perm,
                      const int32_t* flags, int32_t* pe3, int32_t* tx,
                      int32_t* ty, int32_t* tz, int64_t g, int C, int R,
                      int r) {
  const int L = limb_count<F>();
  pt32t<F> acc;
  pt32_identity(acc);
  int64_t e = g * C * R + r;
  for (int c = 0; c < C; ++c, e += R) {
    fe32t<F> x2, y2;
    scan_load_element<COORDS>(x2, y2, packed, perm[e], flags + e);
    fe32_cond_neg(y2, flags[e] & 1);
    pt32_madd(acc, acc, x2, y2);
    scan_store_row(pe3 + e * pe3_row_limbs<F>(), acc);
  }
  const int64_t t = g * L * R + r;
  pt32_store_limbs(tx + t, ty + t, tz + t, R, acc);
}

}  // namespace msm
