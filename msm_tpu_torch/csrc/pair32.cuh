// The pair algebra on the word core, shared by kernel 12 (the suffix
// products, csrc/compress.cu k_pair_suffix) and kernel 13 (the fused pair
// emission + scan, emit_scan.cuh), and kernel 12's per-lane body.
// __host__ __device__, so the host C++ compiler builds it for the CPU
// tests; every function inlines (MSM_HD), so the kernels have no
// out-of-line call.
//
// The pair algebra of csrc/pair.cuh in words. Pair j of lane r adds the
// sorted elements at steps (2j, 2j+1) of the step-major [G, C, R] layout
// (C = 2 Cp):
//
//     d   = x2 - x1 | 2 y1'    (doubling) | R, Montgomery one (P + (-P))
//
// with y' = s ? p - y : y. The packed rows are canonical words, so word
// equality is value equality and "y1 + y2 == p" is one carry ripple. The
// substitution d = R for an infinity pair keeps every chain of products
// free of zeros.
//
// The loads take the table's row layout COORDS (csrc/scan.cuh): under GLV
// an element's x is the half its flags' bit 1 names, so the predicates
// compare the x each element really has -- also when a point of the input
// is phi of another (x_j = beta x_i), where an element of P_i's phi copy
// and one of P_j are a doubling or an infinity pair -- and y comes from
// the third coordinate.
#pragma once

#include "scan.cuh"

namespace msm {

MSM_HD bool fe32_eq(const fe32& a, const fe32& b) {
  uint32_t diff = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) diff |= a.w[i] ^ b.w[i];
  return diff == 0;
}

// a + b == p for canonical a, b: one carry ripple.
MSM_HD bool fe32_sum_is_p(const fe32& a, const fe32& b) {
  uint32_t c = 0, diff = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    const uint64_t s = (uint64_t)a.w[i] + b.w[i] + c;
    diff |= lo32(s) ^ p_word(i);
    c = hi32(s);
  }
  return diff == 0 && c == 0;
}

// One pair: its coordinates with the signs applied to y, and the predicates
//   e1 ==  e2 <=> x1 == x2 and (s1 == s2 ? y1 == y2 : y1 + y2 == p)
//   e1 == -e2 <=> x1 == x2 and (s1 != s2 ? y1 == y2 : y1 + y2 == p)
struct pair32 {
  fe32 x1, y1, x2, y2;  // y1, y2 are the signed y'
  int dbl, inf;
};

// The predicates of a pair whose coordinates are loaded as stored (y not
// yet signed), from its flags (bit 0: negate y); then the signs applied
// to y.
MSM_HD void pair32_make(pair32& pr, int f1, int f2) {
  const int s1 = f1 & 1, s2 = f2 & 1;
  const bool same_x = fe32_eq(pr.x1, pr.x2);
  const bool same_y = fe32_eq(pr.y1, pr.y2);
  const bool ysum_p = fe32_sum_is_p(pr.y1, pr.y2);
  pr.dbl = same_x && (s1 == s2 ? same_y : ysum_p);
  pr.inf = same_x && (s1 == s2 ? ysum_p : same_y);
  fe32_cond_neg(pr.y1, s1);
  fe32_cond_neg(pr.y2, s2);
}

// Gather elements e1, e2 of the step-major perm/flags arrays from the
// packed table [N, COORDS NW].
template <int COORDS = 2>
MSM_HD void pair32_load(pair32& pr, const int32_t* packed, const int32_t* perm,
                        const int32_t* flags, int64_t e1, int64_t e2) {
  scan_load_element<COORDS>(pr.x1, pr.y1, packed, perm[e1], flags + e1);
  scan_load_element<COORDS>(pr.x2, pr.y2, packed, perm[e2], flags + e2);
  pair32_make(pr, flags[e1], flags[e2]);
}

// d = R (infinity) | 2 y1' (doubling) | x2 - x1, branch-free.
MSM_HD void pair32_denominator(fe32& d, const pair32& pr) {
  fe32 dd, one;
  fe32_double(dd, pr.y1);
  fe32_sub(d, pr.x2, pr.x1);
  fe32_mont_one(one);
  const uint32_t dbl = 0u - (uint32_t)(pr.dbl != 0);
  const uint32_t inf = 0u - (uint32_t)(pr.inf != 0);
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    const uint32_t v = (dd.w[i] & dbl) | (d.w[i] & ~dbl);
    d.w[i] = (one.w[i] & inf) | (v & ~inf);
  }
}

// What kernel 12 gathers for one pair: the table rows and flags of its
// two elements and the two x coordinates; the y coordinates only where
// x1 == x2.
struct pair32_x {
  fe32 x1, x2;
  int64_t row1, row2;
  int f1, f2;
};

template <int COORDS = 2>
MSM_HD void pair32_gather_x(pair32_x& q, const int32_t* packed,
                            const int32_t* perm, const int32_t* flags,
                            int64_t e1, int64_t e2) {
  q.row1 = perm[e1];
  q.row2 = perm[e2];
  q.f1 = flags[e1];
  q.f2 = flags[e2];
  scan_load_coord<COORDS>(q.x1, packed, q.row1, row_x_half<COORDS>(&q.f1));
  scan_load_coord<COORDS>(q.x2, packed, q.row2, row_x_half<COORDS>(&q.f2));
}

// d of a gathered pair: x2 - x1, unless x1 == x2 (a doubling, an infinity
// pair, or equal x with unrelated y, where d is x2 - x1 = 0 as in
// pair32_denominator): then the y coordinates are loaded and the pair goes
// through pair32_make and pair32_denominator.
template <int COORDS = 2>
MSM_HD void pair32_denominator_x(fe32& d, const pair32_x& q,
                                 const int32_t* packed) {
  if (fe32_eq(q.x1, q.x2)) {
    pair32 pr;
    pr.x1 = q.x1;
    pr.x2 = q.x2;
    scan_load_coord<COORDS>(pr.y1, packed, q.row1, COORDS - 1);
    scan_load_coord<COORDS>(pr.y2, packed, q.row2, COORDS - 1);
    pair32_make(pr, q.f1, q.f2);
    pair32_denominator(d, pr);
  } else {
    fe32_sub(d, q.x2, q.x1);
  }
}

// Kernel 12: the suffix products s_j = d_j * ... * d_{Cp-1} of lane r of
// subtask g, walking the pairs backwards; s [G, Cp, L, R] canonical 13-bit
// limbs (the contract kernel 13 reads). One product a pair, so a step is
// as long as its gathers unless they are hidden: d needs only the x
// coordinates of a pair unless they are equal, so the gathers read
// 2 x 32 B a pair, not 2 x 64 B; and pair j-1's gathers are issued before
// pair j's product (software pipelining).
template <int COORDS = 2>
MSM_HD void pair_suffix32_lane(const int32_t* packed, const int32_t* perm,
                               const int32_t* flags, int32_t* s, int64_t g,
                               int Cp, int R, int r) {
  const int64_t pair_step = 2 * (int64_t)R;  // perm/flags: one pair further
  const int64_t s_step = (int64_t)L * R;     // s: one pair further
  int64_t e = (g * 2 * Cp + 2 * (int64_t)(Cp - 1)) * R + r;  // step 2j, j = Cp-1
  int64_t o = (g * Cp + Cp - 1) * s_step + r;
  fe32 run;
  fe32_mont_one(run);
  pair32_x next;
  pair32_gather_x<COORDS>(next, packed, perm, flags, e, e + R);
  MSM_ROLLED
  for (int j = Cp - 1; j >= 0; --j, o -= s_step) {
    const pair32_x q = next;
    if (j > 0) {
      e -= pair_step;
      pair32_gather_x<COORDS>(next, packed, perm, flags, e, e + R);
    }
    fe32 d;
    pair32_denominator_x<COORDS>(d, q, packed);
    fe32_mul(run, run, d);
    fe32_store_limbs_strided(s + o, R, run);
  }
}

}  // namespace msm
