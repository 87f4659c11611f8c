// Point formulas of the word core (curve32.cuh) with each formula's
// independent products spread over a group of lanes of a warp (the whole
// warp unless the caller names a narrower group): the latency of a formula
// is two products deep instead of 8 or 12, at the cost of the group's lanes
// per formula. For serial chains and small batches: the Horner ladder
// (kernel 7, csrc/horner.cuh), the point add's small batches (kernel 1,
// csrc/point_add.cuh) and the blocked reduction's chains (kernel 8,
// csrc/bpr.cuh, groups of a few lanes). __host__ __device__, so the host
// C++ compiler builds them for the CPU tests (there one thread computes
// every product of a level).
#pragma once

#include "curve32.cuh"

namespace msm {

// The N independent products of one level of a formula, out[k] = a[k] b[k].
// On the device the warp's lanes form groups of WIDTH (a power of two from
// 2 to 32), each group working on its own formula: lane l of a group
// computes products l, l + WIDTH, ... (a lane past the last product
// repeats the first product of its round), and the group's lanes trade
// them with __shfl_sync, so every lane holds every product; every lane of
// the warp must take part. On the host one thread computes all N.
template <int N, int WIDTH = 32, class F>
MSM_HD void level_products(fe32t<F> (&out)[N], const fe32t<F> (&a)[N],
                           const fe32t<F> (&b)[N]) {
  static_assert(WIDTH >= 2 && WIDTH <= 32 && (WIDTH & (WIDTH - 1)) == 0,
                "a group is a power of two of lanes, at most a warp");
#ifdef __CUDA_ARCH__
  constexpr int ROUNDS = (N + WIDTH - 1) / WIDTH;
  const int lane = threadIdx.x & (WIDTH - 1);
  fe32t<F> r[ROUNDS];
  MSM_UNROLL
  for (int j = 0; j < ROUNDS; ++j) {
    fe32t<F> x = a[j * WIDTH], y = b[j * WIDTH];
    MSM_UNROLL
    for (int k = j * WIDTH + 1; k < N && k < (j + 1) * WIDTH; ++k)
      if (lane == k - j * WIDTH) {
        x = a[k];
        y = b[k];
      }
    fe32_mul(r[j], x, y);
  }
  MSM_UNROLL
  for (int k = 0; k < N; ++k)
    MSM_UNROLL
    for (int i = 0; i < F::NW; ++i)
      out[k].w[i] = WIDTH == 32  // the warp: the shuffle's default width
                        ? __shfl_sync(0xffffffffu, r[k / WIDTH].w[i], k)
                        : __shfl_sync(0xffffffffu, r[k / WIDTH].w[i],
                                      k % WIDTH, WIDTH);
#else
  for (int k = 0; k < N; ++k) fe32_mul(out[k], a[k], b[k]);
#endif
}

// RCB16 Algorithm 9 (pt32_double) with its 8 products in two levels of 4:
// y^2, y z, z^2, x y, then 3b z^2 * 8 y^2, y z * 8 y^2, t0 y3 and t0 x y.
template <class F>
MSM_HD void pt32_double_lanes(pt32t<F>& out, const pt32t<F>& p) {
  fe32t<F> r[4];
  {
    const fe32t<F> a[4] = {p.y, p.y, p.z, p.x}, b[4] = {p.y, p.z, p.z, p.y};
    level_products<4>(r, a, b);
  }
  fe32t<F> z3, t2, y3, t0, u;
  fe32_double(z3, r[0]);
  fe32_double(z3, z3);
  fe32_double(z3, z3);  // 8 y^2
  fe32_mul_b3(t2, r[2]);
  fe32_add(y3, r[0], t2);
  fe32_double(u, t2);
  fe32_add(u, u, t2);
  fe32_sub(t0, r[0], u);  // y^2 - 3 (3b z^2)
  {
    const fe32t<F> a[4] = {t2, r[1], t0, t0}, b[4] = {z3, z3, y3, r[3]};
    level_products<4>(r, a, b);
  }
  fe32_add(out.y, r[0], r[2]);
  out.z = r[1];
  fe32_double(out.x, r[3]);
}

// RCB16 Algorithm 7 (pt32_add) with its 12 products in two levels of 6,
// over groups of WIDTH lanes.
template <int WIDTH = 32, class F>
MSM_HD void pt32_add_lanes(pt32t<F>& out, const pt32t<F>& p, const pt32t<F>& q) {
  fe32t<F> r[6];
  {
    fe32t<F> a[6] = {p.x, p.y, p.z}, b[6] = {q.x, q.y, q.z};
    fe32_add(a[3], p.x, p.y);
    fe32_add(b[3], q.x, q.y);
    fe32_add(a[4], p.y, p.z);
    fe32_add(b[4], q.y, q.z);
    fe32_add(a[5], p.x, p.z);
    fe32_add(b[5], q.x, q.z);
    level_products<6, WIDTH>(r, a, b);
  }
  fe32t<F> t0, t2, t3, t4, t5, u, z3, t1m, y3;
  fe32_add(u, r[0], r[1]);
  fe32_sub(t3, r[3], u);  // x1 y2 + x2 y1
  fe32_add(u, r[1], r[2]);
  fe32_sub(t4, r[4], u);  // y1 z2 + y2 z1
  fe32_add(u, r[0], r[2]);
  fe32_sub(t5, r[5], u);  // x1 z2 + x2 z1
  fe32_double(u, r[0]);
  fe32_add(t0, u, r[0]);  // 3 x1 x2
  fe32_mul_b3(t2, r[2]);
  fe32_add(z3, r[1], t2);
  fe32_sub(t1m, r[1], t2);
  fe32_mul_b3(y3, t5);
  {
    const fe32t<F> a[6] = {t3, t4, t1m, y3, z3, t0}, b[6] = {t1m, y3, z3, t0, t4, t3};
    level_products<6, WIDTH>(r, a, b);
  }
  fe32_sub(out.x, r[0], r[1]);
  fe32_add(out.y, r[2], r[3]);
  fe32_add(out.z, r[4], r[5]);
}

}  // namespace msm
