// Kernel 13 (csrc/pairs.cuh k_emit_scan): the per-lane body on the word
// core, generic over the field (its last template parameter, BN254 by
// default). __host__ __device__, so the host C++ compiler builds it for the
// CPU tests; every function inlines (MSM_HD), so the kernel has no
// out-of-line call.
//
// The pair algebra of csrc/pair.cuh in words. Pair j of lane r adds the
// sorted elements at steps (2j, 2j+1) of the step-major [G, C, R] layout
// (C = 2 Cp):
//
//     d   = x2 - x1 | 2 y1'    (doubling) | R, Montgomery one (P + (-P))
//     num = y2' - y1' | 3 x1^2 (doubling)
//     lam = num / d,  x3 = lam^2 - x1 - x2,  y3 = lam (x1 - x3) - y1'
//
// with y' = s ? p - y : y. The gathers, the predicates, d, num and the
// emission are the pair algebra that kernels 10, 11 and 12 share
// (pair32.cuh).
//
// The forward batch inversion: t runs from t0 = inv(s_0), inv(d_j) =
// t_j s_{j+1} (s_Cp = one), t_{j+1} = t_j d_j. The pair sum goes straight
// into the running point (RCB16 mixed add); an infinity pair leaves it
// unchanged. The boundary contract is kernel 4's: the inclusive prefix after
// pair j as one pe3[g, j, r] row x || y || z of canonical W-bit limbs
// (padded with zero limbs to pe3_row<F>, a multiple of 4: scan.cuh), the
// lane total limbs-first in t{x,y,z}[g, :, r]. The chain input s [G, Cp, L,
// R] is read as canonical W-bit limbs (the suffix kernel's output), t0
// [G, L, R] as balanced ones.
#pragma once

#include "pair32.cuh"

namespace msm {

// packed [N, COORDS NW]; perm, flags [G, 2 Cp, R]; s [G, Cp, L, R]
// canonical; t0 [G, L, R] balanced; pe3 [G, Cp, R, pe3_row<F>]; t* [G, L, R].
template <int COORDS = 2, class F = FpBn254>
MSM_HD void emit_scan_lane(const int32_t* packed, const int32_t* perm,
                           const int32_t* flags, const int32_t* s,
                           const int32_t* t0, int32_t* pe3, int32_t* tx,
                           int32_t* ty, int32_t* tz, int64_t g, int Cp, int R,
                           int r) {
  const int L = limb_count<F>(), ROW = pe3_row_limbs<F>();
  const int64_t lane = g * L * (int64_t)R + r;
  fe32t<F> t;
  if constexpr (F::RT) {
    fe32_load_balanced_rt(t, t0 + lane, R);
  } else {
    int32_t v[F::L];
    MSM_UNROLL
    for (int i = 0; i < F::L; ++i) v[i] = t0[lane + i * (int64_t)R];
    fe32_from_balanced(t, v);
  }
  pt32t<F> acc;
  pt32_identity(acc);
  int64_t e = g * 2 * Cp * (int64_t)R + r;  // step 2j of lane r
  const int64_t s_step = (int64_t)L * R;     // s: one pair further
  const int32_t* s_next = s + g * Cp * s_step + s_step + r;
  int32_t* row = pe3 + (g * Cp * (int64_t)R + r) * ROW;
  for (int j = 0; j < Cp; ++j, e += 2 * (int64_t)R, s_next += s_step,
           row += (int64_t)R * ROW) {
    pair32t<F> pr;
    pair32_load<COORDS>(pr, packed, perm, flags, e, e + R);
    fe32t<F> d, sn, inv_d;
    pair32_denominator(d, pr);
    if (j + 1 < Cp) {
      fe32_load_limbs_strided(sn, s_next, R);
    } else {
      fe32_mont_one(sn);
    }
    // the inverse chain: inv(d_j), then t_{j+1}, independent of acc
    fe32_mul(inv_d, t, sn);
    fe32_mul(t, t, d);
    fe32t<F> num, x3, y3;
    pair32_numerator(num, pr);
    pair32_emit(x3, y3, pr, num, inv_d);
    if (!pr.inf) pt32_madd(acc, acc, x3, y3);
    scan_store_row(row, acc);
  }
  pt32_store_limbs(tx + lane, ty + lane, tz + lane, R, acc);
}

}  // namespace msm
