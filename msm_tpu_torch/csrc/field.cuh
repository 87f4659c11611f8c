// BN254 base-field arithmetic for the CUDA kernels: 13-bit limbs, L = 20,
// Montgomery radix R = 2^260 -- the domain of the JAX reference
// (msm_tpu/ops/pallas_curve.py::_make_field_ops), so every kernel boundary
// compares with the reference after canonicalization.
//
// Contract: an `fe` is CANONICAL -- every limb in [0, 2^13), value in
// [0, p). Every operation here returns a canonical value. This drops the
// TPU's int32 column-budget machinery (dirty outputs, merged REDC,
// the top-limb renormalization fold): with canonical operands a CIOS
// column takes at most 20 * 2 * (2^13 - 1)^2 + 2^19 < 2^32, so uint32
// columns never overflow, and a fully reduced output cannot drift in
// magnitude across chained operations.
//
// Kernel inputs that come from plain tensor code may be in the reference's
// BALANCED form (signed limbs, value in (-R, R)); `fe_from_balanced`
// brings those into the canonical domain with one signed Montgomery
// product by (R mod p).
//
// The functions are __host__ __device__ so that a host C++ compiler can
// build the same header for the CPU tests (MSM_HD expands to plain
// `static inline` outside nvcc).
#pragma once

#include "hd.cuh"

namespace msm {

constexpr int W = 13;
constexpr int L = 20;
constexpr uint32_t MASK = (1u << W) - 1;
// -p^-1 mod 2^13 (params.calc_rinv_and_n0)
constexpr uint32_t N0 = 905;
// 3b for y^2 = x^3 + 3
constexpr int B3 = 9;

// Constant limbs. A local array indexed by an unrolled constant folds to an
// immediate, so the tables cost nothing in device code.
MSM_HD uint32_t p_limb(int i) {
  const uint32_t t[L] = {7495, 999,  1462, 280,  5058, 1350, 455,
                         4653, 362,  3260, 5655, 770,  7016, 2082,
                         1761, 5125, 305,  5015, 6419, 96};
  return t[i];
}

// R mod p: the Montgomery form of 1
MSM_HD uint32_t r_limb(int i) {
  const uint32_t t[L] = {1204, 6119, 61,   1041, 1109, 1236, 2726,
                         2359, 2312, 4684, 82,   798,  472,  5264,
                         7702, 3657, 7095, 4720, 1424, 62};
  return t[i];
}

struct fe {
  uint32_t v[L];
};

MSM_HD void fe_zero(fe& a) {
  MSM_UNROLL
  for (int i = 0; i < L; ++i) a.v[i] = 0;
}

MSM_HD void fe_mont_one(fe& a) {
  MSM_UNROLL
  for (int i = 0; i < L; ++i) a.v[i] = r_limb(i);
}

MSM_HD bool fe_is_zero(const fe& a) {
  uint32_t acc = 0;
  MSM_UNROLL
  for (int i = 0; i < L; ++i) acc |= a.v[i];
  return acc == 0;
}

// Subtract p when a >= p. Input limbs canonical-width, value < 2p.
MSM_HD void fe_reduce_once(fe& a) {
  uint32_t d[L];
  int32_t borrow = 0;
  MSM_UNROLL
  for (int i = 0; i < L; ++i) {
    int32_t t = (int32_t)a.v[i] - (int32_t)p_limb(i) - borrow;
    borrow = t < 0;
    d[i] = (uint32_t)t & MASK;
  }
  if (!borrow) {
    MSM_UNROLL
    for (int i = 0; i < L; ++i) a.v[i] = d[i];
  }
}

MSM_HD void fe_add(fe& out, const fe& a, const fe& b) {
  uint32_t c = 0;
  MSM_UNROLL
  for (int i = 0; i < L; ++i) {
    uint32_t s = a.v[i] + b.v[i] + c;
    out.v[i] = s & MASK;
    c = s >> W;
  }
  // a + b < 2p < 2^260: no carry leaves the top limb
  fe_reduce_once(out);
}

MSM_HD void fe_sub(fe& out, const fe& a, const fe& b) {
  int32_t borrow = 0;
  MSM_UNROLL
  for (int i = 0; i < L; ++i) {
    int32_t t = (int32_t)a.v[i] - (int32_t)b.v[i] - borrow;
    borrow = t < 0;
    out.v[i] = (uint32_t)t & MASK;
  }
  if (borrow) {  // wrapped below zero: add p back
    uint32_t c = 0;
    MSM_UNROLL
    for (int i = 0; i < L; ++i) {
      uint32_t s = out.v[i] + p_limb(i) + c;
      out.v[i] = s & MASK;
      c = s >> W;
    }
  }
}

MSM_HD void fe_neg(fe& out, const fe& a) {
  fe z;
  fe_zero(z);
  fe_sub(out, z, a);
}

MSM_HD void fe_double(fe& out, const fe& a) { fe_add(out, a, a); }

// Montgomery product a*b*R^-1 mod p (CIOS, limb-serial over a). Canonical
// in, canonical out. Column bound: position k collects at most L steps of
// (a_i*b_j + m*p_j) <= 2*(2^13-1)^2, plus one pushed carry < 2^19.4:
// 20 * 134184962 + 2^19.4 < 2^32.
MSM_HD void fe_mul(fe& out, const fe& a, const fe& b) {
  uint32_t t[L];
  MSM_UNROLL
  for (int j = 0; j < L; ++j) t[j] = 0;
  MSM_UNROLL
  for (int i = 0; i < L; ++i) {
    const uint32_t ai = a.v[i];
    MSM_UNROLL
    for (int j = 0; j < L; ++j) t[j] += ai * b.v[j];
    const uint32_t m = ((t[0] & MASK) * N0) & MASK;
    MSM_UNROLL
    for (int j = 0; j < L; ++j) t[j] += m * p_limb(j);
    const uint32_t c = t[0] >> W;  // t[0] == 0 mod 2^13 now
    MSM_UNROLL
    for (int j = 0; j < L - 1; ++j) t[j] = t[j + 1];
    t[L - 1] = 0;
    t[0] += c;
  }
  // value < a*b/R + p < 2p: one carry ripple, one conditional subtract
  uint32_t c = 0;
  MSM_UNROLL
  for (int j = 0; j < L; ++j) {
    uint32_t s = t[j] + c;
    out.v[j] = s & MASK;
    c = s >> W;
  }
  fe_reduce_once(out);
}

MSM_HD void fe_sqr(fe& out, const fe& a) { fe_mul(out, a, a); }

// k * a for the small curve constant (3b), by a double-and-add over fe_add.
template <int K>
MSM_HD void fe_mul_small(fe& out, const fe& a) {
  static_assert(K >= 1, "positive constant");
  fe acc = a;
  int started = 0;
  MSM_UNROLL
  for (int bit = 30; bit >= 0; --bit) {
    if (started) fe_double(acc, acc);
    if ((K >> bit) & 1) {
      if (started) fe_add(acc, acc, a);
      started = 1;
    }
  }
  out = acc;
}

// Balanced -> canonical. `in` holds L signed limbs (the reference's lazy
// representation: value = sum in[i] * 2^(13 i), any limb within int32) with
// value in (-R, R). One signed CIOS product by (R mod p) maps the value to
// T = value (mod p) with T in (-p, 2p); adding p and two conditional
// subtracts give the canonical residue. Montgomery form is preserved
// (x*R * (R mod p) * R^-1 == x*R).
MSM_HD_CALL void fe_from_balanced(fe& out, const int32_t* in) {
  int64_t t[L];
  MSM_UNROLL
  for (int j = 0; j < L; ++j) t[j] = 0;
  MSM_UNROLL
  for (int i = 0; i < L; ++i) {
    const int64_t ai = in[i];
    MSM_UNROLL
    for (int j = 0; j < L; ++j) t[j] += ai * (int64_t)r_limb(j);
    const uint32_t m = (((uint32_t)t[0] & MASK) * N0) & MASK;
    MSM_UNROLL
    for (int j = 0; j < L; ++j) t[j] += (int64_t)m * (int64_t)p_limb(j);
    const int64_t c = t[0] >> W;  // exact: t[0] == 0 mod 2^13
    MSM_UNROLL
    for (int j = 0; j < L - 1; ++j) t[j] = t[j + 1];
    t[L - 1] = 0;
    t[0] += c;
  }
  MSM_UNROLL
  for (int j = 0; j < L; ++j) t[j] += p_limb(j);  // now in (0, 3p)
  int64_t c = 0;
  MSM_UNROLL
  for (int j = 0; j < L; ++j) {
    int64_t s = t[j] + c;
    out.v[j] = (uint32_t)(s & MASK);
    c = s >> W;  // arithmetic shift: floor division for signed columns
  }
  fe_reduce_once(out);
  fe_reduce_once(out);
}

MSM_HD void fe_store(int32_t* dst, const fe& a) {
  MSM_UNROLL
  for (int i = 0; i < L; ++i) dst[i] = (int32_t)a.v[i];
}

// Limb i of a value stored limbs-first at dst[i * stride].
MSM_HD void fe_store_strided(int32_t* dst, int64_t stride, const fe& a) {
  MSM_UNROLL
  for (int i = 0; i < L; ++i) dst[i * stride] = (int32_t)a.v[i];
}

MSM_HD void fe_load_balanced_strided(fe& out, const int32_t* src,
                                     int64_t stride) {
  int32_t tmp[L];
  MSM_UNROLL
  for (int i = 0; i < L; ++i) tmp[i] = src[i * stride];
  fe_from_balanced(out, tmp);
}

// A CANONICAL value stored limbs-first (as the kernels write them): no
// conversion.
MSM_HD void fe_load_strided(fe& out, const int32_t* src, int64_t stride) {
  MSM_UNROLL
  for (int i = 0; i < L; ++i) out.v[i] = (uint32_t)src[i * stride];
}

// Value equality of canonical elements is limb equality.
MSM_HD bool fe_eq(const fe& a, const fe& b) {
  uint32_t acc = 0;
  MSM_UNROLL
  for (int i = 0; i < L; ++i) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// 32-bit words per coordinate of the dense wire format (the packed table).
constexpr int DENSE_WORDS = 8;

// One dense coordinate (DENSE_WORDS words, radix 2^32) -> 13-bit limbs.
MSM_HD void fe_unpack_dense(fe& out, const int32_t* w) {
  uint32_t u[DENSE_WORDS];
  MSM_UNROLL
  for (int k = 0; k < DENSE_WORDS; ++k) u[k] = (uint32_t)w[k];
  MSM_UNROLL
  for (int j = 0; j < L; ++j) {
    const int lo = W * j, k = lo / 32, s = lo % 32;
    uint32_t v = 0;
    if (k < DENSE_WORDS) {
      v = u[k] >> s;
      if (s + W > 32 && k + 1 < DENSE_WORDS) v |= u[k + 1] << (32 - s);
    }
    out.v[j] = v & MASK;
  }
}

}  // namespace msm
