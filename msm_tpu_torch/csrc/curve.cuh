// Complete projective group law for a = 0 short-Weierstrass curves
// (Renes-Costello-Batina 2016) on canonical Montgomery field elements.
// Same formula sequences as the JAX reference: Algorithm 7 is
// msm_tpu/ops/pallas_curve.py::_rcb16_add (CurveCtx.add), Algorithm 8 is
// msm_tpu/ops/pallas_scan.py::_rcb16_madd, Algorithm 9 is CurveCtx.double.
// Identity is (0 : 1 : 0) with 1 in Montgomery form.
#pragma once

#include "field.cuh"

namespace msm {

struct point {
  fe x, y, z;
};

MSM_HD void pt_identity(point& p) {
  fe_zero(p.x);
  fe_mont_one(p.y);
  fe_zero(p.z);
}

// RCB16 Algorithm 7: P + Q for any P, Q (identity, P == Q and P == -Q
// included). 12 products.
MSM_HD_CALL void pt_add(point& out, const point& p, const point& q) {
  fe t0, t1, t2, t3, t4, t5, u, v;
  fe_mul(t0, p.x, q.x);
  fe_mul(t1, p.y, q.y);
  fe_mul(t2, p.z, q.z);
  fe_add(u, p.x, p.y);
  fe_add(v, q.x, q.y);
  fe_mul(t3, u, v);
  fe_add(u, t0, t1);
  fe_sub(t3, t3, u);  // x1 y2 + x2 y1
  fe_add(u, p.y, p.z);
  fe_add(v, q.y, q.z);
  fe_mul(t4, u, v);
  fe_add(u, t1, t2);
  fe_sub(t4, t4, u);  // y1 z2 + y2 z1
  fe_add(u, p.x, p.z);
  fe_add(v, q.x, q.z);
  fe_mul(t5, u, v);
  fe_add(u, t0, t2);
  fe_sub(t5, t5, u);  // x1 z2 + x2 z1
  fe_double(u, t0);
  fe_add(t0, u, t0);  // 3 x1 x2
  fe_mul_small<B3>(t2, t2);
  fe z3, t1m, y3;
  fe_add(z3, t1, t2);
  fe_sub(t1m, t1, t2);
  fe_mul_small<B3>(y3, t5);
  fe_mul(u, t3, t1m);
  fe_mul(v, t4, y3);
  fe_sub(out.x, u, v);
  fe_mul(u, t1m, z3);
  fe_mul(v, y3, t0);
  fe_add(out.y, u, v);
  fe_mul(u, z3, t4);
  fe_mul(v, t0, t3);
  fe_add(out.z, u, v);
}

// RCB16 Algorithm 8: projective P + affine (x2, y2). Complete for any P as
// long as the affine point is a real point (never the identity). 11 products.
MSM_HD_CALL void pt_madd(point& out, const point& p, const fe& x2, const fe& y2) {
  fe t0, t1, t2, t3, t4, y3, u, v;
  fe_mul(t0, p.x, x2);
  fe_mul(t1, p.y, y2);
  fe_add(u, x2, y2);
  fe_add(v, p.x, p.y);
  fe_mul(t3, u, v);
  fe_add(u, t0, t1);
  fe_sub(t3, t3, u);  // x1 y2 + x2 y1
  fe_mul(u, y2, p.z);
  fe_add(t4, u, p.y);  // y1 + y2 z1
  fe_mul(u, x2, p.z);
  fe_add(y3, u, p.x);  // x1 + x2 z1
  fe_double(u, t0);
  fe_add(t0, u, t0);  // 3 x1 x2
  fe_mul_small<B3>(t2, p.z);
  fe z3;
  fe_add(z3, t1, t2);
  fe_sub(t1, t1, t2);
  fe_mul_small<B3>(y3, y3);
  fe_mul(u, t3, t1);
  fe_mul(v, t4, y3);
  fe_sub(out.x, u, v);
  fe_mul(u, y3, t0);
  fe_mul(v, t1, z3);
  fe_add(out.y, u, v);
  fe_mul(u, z3, t4);
  fe_mul(v, t0, t3);
  fe_add(out.z, u, v);
}

// RCB16 Algorithm 9: 2P for any P. 8 products.
MSM_HD_CALL void pt_double(point& out, const point& p) {
  fe t0, t1, t2, x3, y3, z3, u;
  fe_sqr(t0, p.y);
  fe_double(z3, t0);
  fe_double(z3, z3);
  fe_double(z3, z3);  // 8 y^2
  fe_mul(t1, p.y, p.z);
  fe_sqr(u, p.z);
  fe_mul_small<B3>(t2, u);
  fe_mul(x3, t2, z3);
  fe_add(y3, t0, t2);
  fe_mul(z3, t1, z3);
  fe_double(t1, t2);
  fe_add(t2, t1, t2);
  fe_sub(t0, t0, t2);
  fe_mul(u, t0, y3);
  fe_add(y3, x3, u);
  fe_mul(u, p.x, p.y);
  fe_mul(u, t0, u);
  fe_double(x3, u);
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

// y -> p - y (canonical: 0 stays 0)
MSM_HD void pt_neg(point& out, const point& p) {
  out.x = p.x;
  fe_neg(out.y, p.y);
  out.z = p.z;
}

MSM_HD void pt_store(int32_t* x, int32_t* y, int32_t* z, int64_t stride,
                     const point& p) {
  fe_store_strided(x, stride, p.x);
  fe_store_strided(y, stride, p.y);
  fe_store_strided(z, stride, p.z);
}

}  // namespace msm
