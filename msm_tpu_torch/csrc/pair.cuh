// Batched-affine pair compression on canonical Montgomery field elements
// (the 13-bit core): the pair algebra of the forward and backward pair
// kernels (csrc/compress.cu), and the per-lane body of each. Kernels 12
// (suffix products) and 13 (emission + scan) run the same algebra on the
// word core, csrc/pair32.cuh and emit_scan.cuh.
//
// Same algebra as the JAX reference (msm_tpu/ops/pallas_compress.py):
// _load_pair_point, _pair_predicates, _signed_y, _pair_denominator and the
// lambda/x3/y3 emission. Pair j of lane r adds the sorted elements at steps
// (2j, 2j+1) of the step-major layout [G, C, R] (C = 2 Cp):
//
//     d   = x2 - x1 | 2 y1'    (doubling) | R, Montgomery one (P + (-P))
//     num = y2' - y1' | 3 x1^2 (doubling)
//     lam = num / d,  x3 = lam^2 - x1 - x2,  y3 = lam (x1 - x3) - y1'
//
// with y' = s ? p - y : y. The packed table is canonical, so limb equality is
// value equality; "y1 + y2 == p" is one carry ripple. The substitution d = R
// for an infinity pair keeps every chain of products free of zeros.
//
// Chain arrays (running products m, emitted x3 / y3, and kernel 12's suffix
// products s) are limbs-first per lane, [G, Cp, L, R]: neighbouring threads
// (lanes) touch neighbouring words. Values the kernels write are canonical,
// and the chain inputs s and m are read as canonical; the one-per-lane
// values t0 = inv(s_0) and minv = inv(m_last) may be balanced.
//
// Everything is __host__ __device__, so the host C++ compiler builds this
// header for the CPU tests. The functions stay out of line (MSM_HD_CALL):
// nvcc crashed once when every formula was inlined into every kernel.
#pragma once

#include "curve.cuh"

namespace msm {

// One pair, ready for the algebra: canonical coordinates with the signs
// applied to y, and the predicates.
struct pair_t {
  fe x1, y1, x2, y2;  // y1, y2 are the signed y'
  int dbl, inf;
};

// a + b == p for canonical a, b: one ripple, carries in {0, 1}.
MSM_HD bool fe_sum_is_p(const fe& a, const fe& b) {
  uint32_t c = 0, diff = 0;
  MSM_UNROLL
  for (int i = 0; i < L; ++i) {
    const uint32_t s = a.v[i] + b.v[i] + c;
    diff |= (s & MASK) ^ p_limb(i);
    c = s >> W;
  }
  return diff == 0 && c == 0;
}

// Predicates and signed y of the pair (x1, y1, s1), (x2, y2, s2), canonical
// coordinates and sign bits:
//   e1 ==  e2 <=> x1 == x2 and (s1 == s2 ? y1 == y2 : y1 + y2 == p)
//   e1 == -e2 <=> x1 == x2 and (s1 != s2 ? y1 == y2 : y1 + y2 == p)
MSM_HD_CALL void pair_make(pair_t& pr, const fe& x1, const fe& y1, int s1,
                           const fe& x2, const fe& y2, int s2) {
  const bool same_x = fe_eq(x1, x2);
  const bool same_y = fe_eq(y1, y2);
  const bool ysum_p = fe_sum_is_p(y1, y2);
  const bool same_s = s1 == s2;
  pr.dbl = same_x && (same_s ? same_y : ysum_p);
  pr.inf = same_x && (same_s ? ysum_p : same_y);
  pr.x1 = x1;
  pr.x2 = x2;
  if (s1) fe_neg(pr.y1, y1); else pr.y1 = y1;
  if (s2) fe_neg(pr.y2, y2); else pr.y2 = y2;
}

// Gather and unpack the elements e1, e2 of the step-major perm/flags arrays
// (flags bit 0: negate y) from the packed table [N, 2 DENSE_WORDS].
MSM_HD_CALL void pair_load(pair_t& pr, const int32_t* packed,
                           const int32_t* perm, const int32_t* flags,
                           int64_t e1, int64_t e2) {
  constexpr int D = DENSE_WORDS;
  const int64_t r1 = perm[e1], r2 = perm[e2];
  fe x1, y1, x2, y2;
  fe_unpack_dense(x1, packed + r1 * 2 * D);
  fe_unpack_dense(y1, packed + r1 * 2 * D + D);
  fe_unpack_dense(x2, packed + r2 * 2 * D);
  fe_unpack_dense(y2, packed + r2 * 2 * D + D);
  pair_make(pr, x1, y1, flags[e1] & 1, x2, y2, flags[e2] & 1);
}

MSM_HD_CALL void pair_denominator(fe& d, const pair_t& pr) {
  if (pr.inf) {
    fe_mont_one(d);
  } else if (pr.dbl) {
    fe_double(d, pr.y1);
  } else {
    fe_sub(d, pr.x2, pr.x1);
  }
}

MSM_HD_CALL void pair_numerator(fe& num, const pair_t& pr) {
  if (pr.dbl) {
    fe sq;
    fe_sqr(sq, pr.x1);
    fe_double(num, sq);
    fe_add(num, num, sq);
  } else {
    fe_sub(num, pr.y2, pr.y1);
  }
}

// The affine pair sum from num and inv_d = 1/d.
MSM_HD_CALL void pair_emit(fe& x3, fe& y3, const pair_t& pr, const fe& num,
                           const fe& inv_d) {
  fe lam, t;
  fe_mul(lam, num, inv_d);
  fe_sqr(t, lam);
  fe_sub(t, t, pr.x1);
  fe_sub(x3, t, pr.x2);
  fe_sub(t, pr.x1, x3);
  fe_mul(t, lam, t);
  fe_sub(y3, t, pr.y1);
}

// -- per-lane bodies: one call per (subtask g, lane r) ------------------------

// Element (step c, lane r) of subtask g in the step-major [G, C, R] layout.
MSM_HD int64_t step_at(int64_t g, int c, int C, int R, int r) {
  return (g * C + c) * (int64_t)R + r;
}

// Limb 0 of (pair j, lane r) of subtask g in a limbs-first [G, Cp, L, R]
// chain array; limb i is i * R further.
MSM_HD int64_t chain_at(int64_t g, int j, int Cp, int R, int r) {
  return (g * Cp + j) * (int64_t)L * R + r;
}

MSM_HD void lane_pair(pair_t& pr, fe& d, const int32_t* packed,
                      const int32_t* perm, const int32_t* flags, int64_t g,
                      int j, int Cp, int R, int r) {
  const int C = 2 * Cp;
  pair_load(pr, packed, perm, flags, step_at(g, 2 * j, C, R, r),
            step_at(g, 2 * j + 1, C, R, r));
  pair_denominator(d, pr);
}

// Kernel 10: inclusive running products m_j = d_0 * ... * d_j.
MSM_HD_CALL void pair_forward_lane(const int32_t* packed, const int32_t* perm,
                                   const int32_t* flags, int32_t* m, int64_t g,
                                   int Cp, int R, int r) {
  fe run;
  fe_mont_one(run);
  for (int j = 0; j < Cp; ++j) {
    pair_t pr;
    fe d;
    lane_pair(pr, d, packed, perm, flags, g, j, Cp, R, r);
    fe_mul(run, run, d);
    fe_store_strided(m + chain_at(g, j, Cp, R, r), R, run);
  }
}

// Kernel 11: backward emission of the pair sums. run starts at
// minv = inv(m_last); pair j reads m_{j-1} (m_{-1} = one):
// inv(d_j) = m_{j-1} * run, then run *= d_j. Writes x3, y3 limbs-first and
// the infinity flag inf[g, j, r].
MSM_HD_CALL void pair_backward_lane(const int32_t* packed, const int32_t* perm,
                                    const int32_t* flags, const int32_t* m,
                                    const int32_t* minv, int32_t* cx,
                                    int32_t* cy, int32_t* inf, int64_t g,
                                    int Cp, int R, int r) {
  fe run;
  fe_load_balanced_strided(run, minv + g * L * (int64_t)R + r, R);
  for (int j = Cp - 1; j >= 0; --j) {
    pair_t pr;
    fe d, num, mprev, inv_d, x3, y3;
    lane_pair(pr, d, packed, perm, flags, g, j, Cp, R, r);
    pair_numerator(num, pr);
    if (j > 0) {
      fe_load_strided(mprev, m + chain_at(g, j - 1, Cp, R, r), R);
    } else {
      fe_mont_one(mprev);
    }
    fe_mul(inv_d, mprev, run);
    pair_emit(x3, y3, pr, num, inv_d);
    fe_mul(run, run, d);
    const int64_t o = chain_at(g, j, Cp, R, r);
    fe_store_strided(cx + o, R, x3);
    fe_store_strided(cy + o, R, y3);
    inf[(g * Cp + j) * (int64_t)R + r] = pr.inf;
  }
}

}  // namespace msm
