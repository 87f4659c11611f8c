// Kernel 4 (csrc/scan.cu): the per-lane body on the word core.
// __host__ __device__, so the host C++ compiler builds it for the CPU tests.
//
// Lane r of subtask g walks its C steps: step c folds in table row
// perm[g, c, r] (y negated when flags[g, c, r] & 1) with RCB16 Algorithm 8
// and writes the running sum as one pe3[g, c, r] row x || y || z of
// canonical 13-bit limbs [3L]; the sum after the last step goes to the lane
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
// [N, COORDS NW]: 32 B; on the device two 16-byte loads through the
// read-only cache (rows are 64 B or 96 B, so 16 B aligned).
template <int COORDS = 2>
MSM_HD void scan_load_coord(fe32& c, const int32_t* packed, int64_t row,
                            int half) {
  const int32_t* src = packed + (row * COORDS + half) * NW;
#ifdef __CUDA_ARCH__
  const int4* q = reinterpret_cast<const int4*>(src);
  const int4 a = __ldg(q), b = __ldg(q + 1);
  c.w[0] = a.x; c.w[1] = a.y; c.w[2] = a.z; c.w[3] = a.w;
  c.w[4] = b.x; c.w[5] = b.y; c.w[6] = b.z; c.w[7] = b.w;
#else
  fe32_load_dense(c, src);
#endif
}

// An element's x and y from table row `row` of packed [N, COORDS NW], its
// flags at `flag` choosing the x half of a GLV row.
template <int COORDS>
MSM_HD void scan_load_element(fe32& x, fe32& y, const int32_t* packed,
                              int64_t row, const int32_t* flag) {
  scan_load_coord<COORDS>(x, packed, row, row_x_half<COORDS>(flag));
  scan_load_coord<COORDS>(y, packed, row, COORDS - 1);
}

// One pe3 row (3L limbs, 240 B, 16 B aligned); on the device 15 16-byte
// stores.
MSM_HD void scan_store_row(int32_t* dst, const pt32& p) {
  uint32_t v[3 * L];
  fe32_to_limbs(v, p.x);
  fe32_to_limbs(v + L, p.y);
  fe32_to_limbs(v + 2 * L, p.z);
#ifdef __CUDA_ARCH__
  int4* q = reinterpret_cast<int4*>(dst);
  MSM_UNROLL
  for (int k = 0; k < 3 * L / 4; ++k)
    q[k] = make_int4((int)v[4 * k], (int)v[4 * k + 1], (int)v[4 * k + 2],
                     (int)v[4 * k + 3]);
#else
  for (int k = 0; k < 3 * L; ++k) dst[k] = (int32_t)v[k];
#endif
}

// y <- p - y where neg, else y (branch-free; 0 stays 0).
MSM_HD void fe32_cond_neg(fe32& y, int neg) {
  fe32 n;
  fe32_neg(n, y);
  const uint32_t sel = 0u - (uint32_t)(neg != 0);
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) y.w[i] = (n.w[i] & sel) | (y.w[i] & ~sel);
}

// packed [N, COORDS NW]; perm, flags [G, C, R]; pe3 [G, C, R, 3L];
// t* [G, L, R].
template <int COORDS = 2>
MSM_HD void scan_lane(const int32_t* packed, const int32_t* perm,
                      const int32_t* flags, int32_t* pe3, int32_t* tx,
                      int32_t* ty, int32_t* tz, int64_t g, int C, int R,
                      int r) {
  pt32 acc;
  pt32_identity(acc);
  int64_t e = g * C * R + r;
  for (int c = 0; c < C; ++c, e += R) {
    fe32 x2, y2;
    scan_load_element<COORDS>(x2, y2, packed, perm[e], flags + e);
    fe32_cond_neg(y2, flags[e] & 1);
    pt32_madd(acc, acc, x2, y2);
    scan_store_row(pe3 + e * 3 * L, acc);
  }
  const int64_t t = g * L * R + r;
  pt32_store_limbs(tx + t, ty + t, tz + t, R, acc);
}

}  // namespace msm
