// The complete a = 0 group law (Renes-Costello-Batina 2016) on the word
// core (fe32.cuh), generic over the field: the same formula sequences as
// curve.cuh -- Algorithm 7 (pt32_add), 8 (pt32_madd) and 9 (pt32_double),
// the product by 3b as fe32_mul_b3 -- inlined, so a formula's
// independent products interleave in one instruction stream and a kernel
// keeps its points in registers (no out-of-line call, no stack frame).
// Identity is (0 : 1 : 0) with 1 in Montgomery form.
#pragma once

#include "fe32.cuh"

namespace msm {

template <class F>
struct pt32t {
  fe32t<F> x, y, z;
};

template <class F>
MSM_HD void pt32_identity(pt32t<F>& p) {
  fe32_zero(p.x);
  fe32_mont_one(p.y);
  fe32_zero(p.z);
}

// RCB16 Algorithm 7: P + Q for any P, Q. 12 products.
template <class F>
MSM_HD void pt32_add(pt32t<F>& out, const pt32t<F>& p, const pt32t<F>& q) {
  fe32t<F> t0, t1, t2, t3, t4, t5, u, v;
  fe32_mul(t0, p.x, q.x);
  fe32_mul(t1, p.y, q.y);
  fe32_mul(t2, p.z, q.z);
  fe32_add(u, p.x, p.y);
  fe32_add(v, q.x, q.y);
  fe32_mul(t3, u, v);
  fe32_add(u, t0, t1);
  fe32_sub(t3, t3, u);  // x1 y2 + x2 y1
  fe32_add(u, p.y, p.z);
  fe32_add(v, q.y, q.z);
  fe32_mul(t4, u, v);
  fe32_add(u, t1, t2);
  fe32_sub(t4, t4, u);  // y1 z2 + y2 z1
  fe32_add(u, p.x, p.z);
  fe32_add(v, q.x, q.z);
  fe32_mul(t5, u, v);
  fe32_add(u, t0, t2);
  fe32_sub(t5, t5, u);  // x1 z2 + x2 z1
  fe32_double(u, t0);
  fe32_add(t0, u, t0);  // 3 x1 x2
  fe32_mul_b3(t2, t2);
  fe32t<F> z3, t1m, y3;
  fe32_add(z3, t1, t2);
  fe32_sub(t1m, t1, t2);
  fe32_mul_b3(y3, t5);
  fe32_mul(u, t3, t1m);
  fe32_mul(v, t4, y3);
  fe32_sub(out.x, u, v);
  fe32_mul(u, t1m, z3);
  fe32_mul(v, y3, t0);
  fe32_add(out.y, u, v);
  fe32_mul(u, z3, t4);
  fe32_mul(v, t0, t3);
  fe32_add(out.z, u, v);
}

// RCB16 Algorithm 8: projective P + affine (x2, y2), complete while the
// affine point is a real point (never the identity). 11 products.
template <class F>
MSM_HD void pt32_madd(pt32t<F>& out, const pt32t<F>& p, const fe32t<F>& x2,
                      const fe32t<F>& y2) {
  fe32t<F> t0, t1, t2, t3, t4, y3, u, v;
  fe32_mul(t0, p.x, x2);
  fe32_mul(t1, p.y, y2);
  fe32_add(u, x2, y2);
  fe32_add(v, p.x, p.y);
  fe32_mul(t3, u, v);
  fe32_add(u, t0, t1);
  fe32_sub(t3, t3, u);  // x1 y2 + x2 y1
  fe32_mul(u, y2, p.z);
  fe32_add(t4, u, p.y);  // y1 + y2 z1
  fe32_mul(u, x2, p.z);
  fe32_add(y3, u, p.x);  // x1 + x2 z1
  fe32_double(u, t0);
  fe32_add(t0, u, t0);  // 3 x1 x2
  fe32_mul_b3(t2, p.z);
  fe32t<F> z3;
  fe32_add(z3, t1, t2);
  fe32_sub(t1, t1, t2);
  fe32_mul_b3(y3, y3);
  fe32_mul(u, t3, t1);
  fe32_mul(v, t4, y3);
  fe32_sub(out.x, u, v);
  fe32_mul(u, y3, t0);
  fe32_mul(v, t1, z3);
  fe32_add(out.y, u, v);
  fe32_mul(u, z3, t4);
  fe32_mul(v, t0, t3);
  fe32_add(out.z, u, v);
}

// RCB16 Algorithm 9: 2P for any P. 8 products.
template <class F>
MSM_HD void pt32_double(pt32t<F>& out, const pt32t<F>& p) {
  fe32t<F> t0, t1, t2, x3, y3, z3, u;
  fe32_sqr(t0, p.y);
  fe32_double(z3, t0);
  fe32_double(z3, z3);
  fe32_double(z3, z3);  // 8 y^2
  fe32_mul(t1, p.y, p.z);
  fe32_sqr(u, p.z);
  fe32_mul_b3(t2, u);
  fe32_mul(x3, t2, z3);
  fe32_add(y3, t0, t2);
  fe32_mul(z3, t1, z3);
  fe32_double(t1, t2);
  fe32_add(t2, t1, t2);
  fe32_sub(t0, t0, t2);
  fe32_mul(u, t0, y3);
  fe32_add(y3, x3, u);
  fe32_mul(u, p.x, p.y);
  fe32_mul(u, t0, u);
  fe32_double(x3, u);
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

// A point from three balanced [L] limb rows (kernel inputs that plain
// tensor code may write).
template <class F>
MSM_HD void pt32_load_balanced(pt32t<F>& p, const int32_t* x, const int32_t* y,
                               const int32_t* z) {
  fe32_from_balanced(p.x, x);
  fe32_from_balanced(p.y, y);
  fe32_from_balanced(p.z, z);
}

// Canonical W-bit limbs, limb i of each coordinate at [i * stride].
template <class F>
MSM_HD void pt32_store_limbs(int32_t* x, int32_t* y, int32_t* z,
                             int64_t stride, const pt32t<F>& p) {
  fe32_store_limbs_strided(x, stride, p.x);
  fe32_store_limbs_strided(y, stride, p.y);
  fe32_store_limbs_strided(z, stride, p.z);
}

using pt32 = pt32t<FpBn254>;

}  // namespace msm
