// The pair algebra on the word core, generic over the field (a traits type
// of fields.cuh), shared by the four pair kernels: the forward products
// (kernel 10, csrc/compress.cu k_pair_forward), the backward emission (11,
// k_pair_backward), the suffix products (12, csrc/pairs.cuh k_pair_suffix)
// and the fused pair emission + scan (13, emit_scan.cuh); and the per-lane
// bodies of kernels 10 and 12 (one body walking either way) and 11. Kernels
// 12 and 13 are instantiated for every curve, kernels 10 and 11 for BN254
// (the field a body's last template parameter, BN254 by default).
// __host__ __device__, so the host C++ compiler builds it for the CPU tests
// (every field); every function inlines (MSM_HD), so the kernels have no
// out-of-line call.
//
// Pair j of lane r adds the sorted elements at steps (2j, 2j+1) of the
// step-major [G, C, R] layout (C = 2 Cp):
//
//     d   = x2 - x1 | 2 y1'    (doubling) | R, Montgomery one (P + (-P))
//     num = y2' - y1' | 3 x1^2 (doubling)
//     lam = num / d,  x3 = lam^2 - x1 - x2,  y3 = lam (x1 - x3) - y1'
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
//
// Chain arrays (the running products m of kernel 10, the suffix products
// s of kernel 12, the pair sums cx, cy of kernel 11) are canonical W-bit
// limbs, limbs-first per lane, [G, Cp, L, R]: neighbouring threads (lanes)
// touch neighbouring words, and the kernels that read them (9, 11, 13)
// take that layout. The one-per-lane inverse minv = inv(m_last) may be
// balanced.
#pragma once

#include "scan.cuh"

namespace msm {

template <class F>
MSM_HD bool fe32_eq(const fe32t<F>& a, const fe32t<F>& b) {
  uint32_t diff = 0;
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) diff |= a.w[i] ^ b.w[i];
  return diff == 0;
}

// a + b == p for canonical a, b: one carry ripple over NW words. A sum that
// carries out of word NW - 1 (secp256k1's, F::CARRY: p is within 2^32 of
// 2^256) is at least 2^(32 NW) > p.
template <class F>
MSM_HD bool fe32_sum_is_p(const fe32t<F>& a, const fe32t<F>& b) {
  uint32_t c = 0, diff = 0;
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) {
    const uint64_t s = (uint64_t)a.w[i] + b.w[i] + c;
    diff |= lo32(s) ^ F::p(i);
    c = hi32(s);
  }
  return diff == 0 && c == 0;
}

// One pair: its coordinates with the signs applied to y, and the predicates
//   e1 ==  e2 <=> x1 == x2 and (s1 == s2 ? y1 == y2 : y1 + y2 == p)
//   e1 == -e2 <=> x1 == x2 and (s1 != s2 ? y1 == y2 : y1 + y2 == p)
template <class F>
struct pair32t {
  fe32t<F> x1, y1, x2, y2;  // y1, y2 are the signed y'
  int dbl, inf;
};

using pair32 = pair32t<FpBn254>;

// The predicates of a pair whose coordinates are loaded as stored (y not
// yet signed), from its flags (bit 0: negate y); then the signs applied
// to y.
template <class F>
MSM_HD void pair32_make(pair32t<F>& pr, int f1, int f2) {
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
template <int COORDS = 2, class F>
MSM_HD void pair32_load(pair32t<F>& pr, const int32_t* packed,
                        const int32_t* perm, const int32_t* flags, int64_t e1,
                        int64_t e2) {
  scan_load_element<COORDS>(pr.x1, pr.y1, packed, perm[e1], flags + e1);
  scan_load_element<COORDS>(pr.x2, pr.y2, packed, perm[e2], flags + e2);
  pair32_make(pr, flags[e1], flags[e2]);
}

// d = R (infinity) | 2 y1' (doubling) | x2 - x1, branch-free.
template <class F>
MSM_HD void pair32_denominator(fe32t<F>& d, const pair32t<F>& pr) {
  fe32t<F> dd, one;
  fe32_double(dd, pr.y1);
  fe32_sub(d, pr.x2, pr.x1);
  fe32_mont_one(one);
  const uint32_t dbl = 0u - (uint32_t)(pr.dbl != 0);
  const uint32_t inf = 0u - (uint32_t)(pr.inf != 0);
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) {
    const uint32_t v = (dd.w[i] & dbl) | (d.w[i] & ~dbl);
    d.w[i] = (one.w[i] & inf) | (v & ~inf);
  }
}

// num = 3 x1^2 (doubling: the one product, in warps that hold a doubling)
// | y2' - y1'.
template <class F>
MSM_HD void pair32_numerator(fe32t<F>& num, const pair32t<F>& pr) {
  if (pr.dbl) {
    fe32t<F> sq, t;
    fe32_sqr(sq, pr.x1);
    fe32_double(t, sq);
    fe32_add(num, t, sq);
  } else {
    fe32_sub(num, pr.y2, pr.y1);
  }
}

// The affine pair sum from num and inv_d = 1/d: 3 products.
template <class F>
MSM_HD void pair32_emit(fe32t<F>& x3, fe32t<F>& y3, const pair32t<F>& pr,
                        const fe32t<F>& num, const fe32t<F>& inv_d) {
  fe32t<F> lam, t;
  fe32_mul(lam, num, inv_d);
  fe32_sqr(t, lam);
  fe32_sub(t, t, pr.x1);
  fe32_sub(x3, t, pr.x2);
  fe32_sub(t, pr.x1, x3);
  fe32_mul(t, lam, t);
  fe32_sub(y3, t, pr.y1);
}

// What kernels 10 and 12 gather for one pair: the table rows and flags of
// its two elements and the two x coordinates; the y coordinates only where
// x1 == x2.
template <class F>
struct pair32_xt {
  fe32t<F> x1, x2;
  int64_t row1, row2;
  int f1, f2;
};

using pair32_x = pair32_xt<FpBn254>;

template <int COORDS = 2, class F>
MSM_HD void pair32_gather_x(pair32_xt<F>& q, const int32_t* packed,
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
template <int COORDS = 2, class F>
MSM_HD void pair32_denominator_x(fe32t<F>& d, const pair32_xt<F>& q,
                                 const int32_t* packed) {
  if (fe32_eq(q.x1, q.x2)) {
    pair32t<F> pr;
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

// Kernels 10 and 12: the running products of lane r of subtask g, one
// product a pair. FORWARD (kernel 10) walks the pairs forwards and stores
// m_j = d_0 * ... * d_j; else (kernel 12) it walks them backwards and
// stores the suffix products s_j = d_j * ... * d_{Cp-1}. The products,
// [G, Cp, L, R] canonical W-bit limbs, are the contract kernels 9, 11 and
// 13 read. A step is as long as its gathers unless they are hidden: d
// needs only the x coordinates of a pair unless they are equal, so the
// gathers read 2 x 32 B a pair, not 2 x 64 B; and the next pair's gathers
// are issued before this pair's product (software pipelining).
template <int COORDS, bool FORWARD, class F = FpBn254>
MSM_HD void pair_chain32_lane(const int32_t* packed, const int32_t* perm,
                              const int32_t* flags, int32_t* out, int64_t g,
                              int Cp, int R, int r) {
  const int64_t pair_step = 2 * (int64_t)R;   // perm/flags: one pair further
  const int64_t out_step = (int64_t)limb_count<F>() * R;  // out: one pair further
  const int first = FORWARD ? 0 : Cp - 1;
  // step 2j and product j of the first pair (j = first)
  int64_t e = FORWARD ? g * 2 * Cp * (int64_t)R + r
                      : (g * 2 * Cp + 2 * (int64_t)(Cp - 1)) * R + r;
  int64_t o = FORWARD ? g * Cp * out_step + r : (g * Cp + Cp - 1) * out_step + r;
  fe32t<F> run;
  fe32_mont_one(run);
  pair32_xt<F> next;
  pair32_gather_x<COORDS>(next, packed, perm, flags, e, e + R);
  MSM_ROLLED
  for (int j = first; FORWARD ? j < Cp : j >= 0; j += FORWARD ? 1 : -1) {
    const pair32_xt<F> q = next;
    if (FORWARD ? j + 1 < Cp : j > 0) {
      if constexpr (FORWARD) e += pair_step; else e -= pair_step;
      pair32_gather_x<COORDS>(next, packed, perm, flags, e, e + R);
    }
    fe32t<F> d;
    pair32_denominator_x<COORDS>(d, q, packed);
    fe32_mul(run, run, d);
    fe32_store_limbs_strided(out + o, R, run);
    if constexpr (FORWARD) o += out_step; else o -= out_step;
  }
}

// Kernel 11: the backward emission of lane r of subtask g. run starts at
// minv = inv(m_{Cp-1}) (balanced limbs [G, L, R]); pair j, from Cp - 1 down
// to 0, reads m_{j-1} (one at j = 0): inv(d_j) = m_{j-1} run, the pair sum
// from it (pair32_emit), then run *= d_j. Writes cx, cy [G, Cp, L, R]
// canonical W-bit limbs and inf [G, Cp, R] (an infinity pair's cx, cy
// mean nothing). 5 products a pair, 6 for a doubling.
template <int COORDS = 2, class F = FpBn254>
MSM_HD void pair_backward32_lane(const int32_t* packed, const int32_t* perm,
                                 const int32_t* flags, const int32_t* m,
                                 const int32_t* minv, int32_t* cx,
                                 int32_t* cy, int32_t* inf, int64_t g, int Cp,
                                 int R, int r) {
  const int64_t c_step = (int64_t)limb_count<F>() * R;  // m, cx, cy: one pair further
  fe32t<F> run;
  if constexpr (F::RT) {
    fe32_load_balanced_rt(run, minv + g * c_step + r, R);
  } else {
    int32_t v[F::L];
    const int64_t lane = g * c_step + r;
    MSM_UNROLL
    for (int i = 0; i < F::L; ++i) v[i] = minv[lane + i * (int64_t)R];
    fe32_from_balanced(run, v);
  }
  int64_t e = (g * 2 * Cp + 2 * (int64_t)(Cp - 1)) * R + r;  // step 2j, j = Cp-1
  int64_t o = (g * Cp + Cp - 1) * c_step + r;
  int64_t f = (g * Cp + Cp - 1) * (int64_t)R + r;
  MSM_ROLLED
  for (int j = Cp - 1; j >= 0; --j, e -= 2 * (int64_t)R, o -= c_step, f -= R) {
    pair32t<F> pr;
    pair32_load<COORDS>(pr, packed, perm, flags, e, e + R);
    fe32t<F> d, num, mprev, inv_d, x3, y3;
    pair32_denominator(d, pr);
    pair32_numerator(num, pr);
    if (j > 0) {
      fe32_load_limbs_strided(mprev, m + o - c_step, R);
    } else {
      fe32_mont_one(mprev);
    }
    fe32_mul(inv_d, mprev, run);
    pair32_emit(x3, y3, pr, num, inv_d);
    fe32_mul(run, run, d);
    fe32_store_limbs_strided(cx + o, R, x3);
    fe32_store_limbs_strided(cy + o, R, y3);
    inf[f] = pr.inf;
  }
}

}  // namespace msm
