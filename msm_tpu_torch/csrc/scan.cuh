// Kernel 4 (csrc/scan.cu): the per-lane body on the word core.
// __host__ __device__, so the host C++ compiler builds it for the CPU tests.
//
// Lane r of subtask g walks its C steps: step c folds in table row
// perm[g, c, r] (y negated when flags[g, c, r] & 1) with RCB16 Algorithm 8
// and writes the running sum as one pe3[g, c, r] row x || y || z of
// canonical 13-bit limbs [3L]; the sum after the last step goes to the lane
// totals t{x,y,z}[g, :, r], limbs-first.
#pragma once

#include "curve32.cuh"

namespace msm {

// Table row `row` of packed [N, 2 NW] (x's words, then y's); on the device
// four 16-byte loads through the read-only cache (rows are 64 B aligned).
MSM_HD void scan_load_row(fe32& x, fe32& y, const int32_t* packed,
                          int64_t row) {
  const int32_t* src = packed + row * 2 * NW;
#ifdef __CUDA_ARCH__
  const int4* q = reinterpret_cast<const int4*>(src);
  const int4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2),
             d = __ldg(q + 3);
  x.w[0] = a.x; x.w[1] = a.y; x.w[2] = a.z; x.w[3] = a.w;
  x.w[4] = b.x; x.w[5] = b.y; x.w[6] = b.z; x.w[7] = b.w;
  y.w[0] = c.x; y.w[1] = c.y; y.w[2] = c.z; y.w[3] = c.w;
  y.w[4] = d.x; y.w[5] = d.y; y.w[6] = d.z; y.w[7] = d.w;
#else
  fe32_load_dense(x, src);
  fe32_load_dense(y, src + NW);
#endif
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

// packed [N, 2 NW]; perm, flags [G, C, R]; pe3 [G, C, R, 3L];
// t* [G, L, R].
MSM_HD void scan_lane(const int32_t* packed, const int32_t* perm,
                      const int32_t* flags, int32_t* pe3, int32_t* tx,
                      int32_t* ty, int32_t* tz, int64_t g, int C, int R,
                      int r) {
  pt32 acc;
  pt32_identity(acc);
  int64_t e = g * C * R + r;
  for (int c = 0; c < C; ++c, e += R) {
    fe32 x2, y2;
    scan_load_row(x2, y2, packed, perm[e]);
    fe32_cond_neg(y2, flags[e] & 1);
    pt32_madd(acc, acc, x2, y2);
    scan_store_row(pe3 + e * 3 * L, acc);
  }
  const int64_t t = g * L * R + r;
  pt32_store_limbs(tx + t, ty + t, tz + t, R, acc);
}

}  // namespace msm
