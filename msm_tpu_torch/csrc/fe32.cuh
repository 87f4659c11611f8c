// BN254 base-field arithmetic in 32-bit words: the word core of the point
// add (kernel 1), the point conversion (2), the scan (4), the point total
// (6), the Horner ladder (7), the Fermat inversion (9) and the four pair
// kernels: the forward products (10), the backward emission (11), the
// suffix products (12) and the fused pair emission + scan (13).
//
// An `fe32` is 8 words, least significant first, CANONICAL (value in
// [0, p)), in the same Montgomery domain as the 13-bit core of field.cuh:
// R = 2^260. Kernel boundaries keep field.cuh's canonical 13-bit limbs; the
// kernels repack with shifts only (fe32_from_limbs, fe32_to_limbs), and the
// packed table's dense words (field.cuh DENSE_WORDS, radix 2^32) are
// already this form. A canonical value is unique, so a kernel on this core
// writes exactly the limbs the 13-bit core would.
//
// The R = 2^260 product is a word-level CIOS with n0 = -p^-1 mod 2^32 (a
// REDC by 2^256, leaving t < 2p), one 4-bit REDC step (m = t * (-p^-1 mod
// 16) mod 16, t = (t + m p) / 16, again < 2p) and one conditional subtract:
// a b 2^-260 mod p, with no product spent on changing domains. The CIOS is
// the "no-carry" form (the top word of p is below 2^31 - 1, so the running
// sum never needs a ninth word). 8 x 8 word multiply-adds for a b and as
// many for m p, against 20 x 20 of each on 13-bit limbs.
//
// Portable code: 64-bit accumulators that nvcc lowers to IMAD.WIDE.U32, so
// g++ builds this header for the CPU tests and checks the arithmetic the
// card runs. PTX carry chains (mad.lo.cc / madc.hi.cc) are not used yet:
// they would give the device a second product that only chip_smoke.py
// checks. Every function inlines (MSM_HD): kernels on this core have no
// out-of-line call.
#pragma once

#include "field.cuh"

namespace msm {

constexpr int NW = 8;  // words per element
// -p^-1 mod 2^32, and mod 16 for the last 4-bit REDC step
constexpr uint32_t N0W = 0xe4866389u;
constexpr uint32_t N0NIB = 9;

MSM_HD uint32_t p_word(int i) {
  const uint32_t t[NW] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                          0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
  return t[i];
}

// R mod p (R = 2^260): the Montgomery form of 1
MSM_HD uint32_t r_word(int i) {
  const uint32_t t[NW] = {0xf6fce4b4u, 0x45520880u, 0xbaa989a8u, 0x49890849u,
                          0x818f014au, 0x85a9201du, 0x1bb7724fu, 0x1f16424eu};
  return t[i];
}

// R^2 mod p: a product by it enters Montgomery form (a -> a R mod p)
MSM_HD uint32_t r2_word(int i) {
  const uint32_t t[NW] = {0x1966eb04u, 0xb868a81du, 0x95018016u, 0x98e61561u,
                          0x0b4f898cu, 0xbfd53160u, 0x0d3a9969u, 0x0a8469a3u};
  return t[i];
}

// Word i (of NW + 1) of p << s, 0 <= s < 32.
MSM_HD uint32_t p_shl_word(int i, int s) {
  const uint32_t lo = i < NW ? p_word(i) << s : 0u;
  const uint32_t hi = (i > 0 && s > 0) ? p_word(i - 1) >> (32 - s) : 0u;
  return lo | hi;
}

struct fe32 {
  uint32_t w[NW];
};

MSM_HD void fe32_zero(fe32& a) {
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) a.w[i] = 0;
}

MSM_HD void fe32_mont_one(fe32& a) {
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) a.w[i] = r_word(i);
}

MSM_HD uint32_t lo32(uint64_t v) { return (uint32_t)v; }
MSM_HD uint32_t hi32(uint64_t v) { return (uint32_t)(v >> 32); }

// a <- a - p when a >= p (a < 2^256), branch-free.
MSM_HD void fe32_reduce_once(fe32& a) {
  uint32_t d[NW];
  uint32_t borrow = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    const uint64_t t = (uint64_t)a.w[i] - p_word(i) - borrow;
    d[i] = lo32(t);
    borrow = hi32(t) & 1u;
  }
  const uint32_t keep = 0u - borrow;  // all ones: a < p, keep a
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) a.w[i] = (a.w[i] & keep) | (d[i] & ~keep);
}

// a <- a mod p for any a < 2^256 (< 5.3 p): branch-free conditional
// subtracts of 4p, 2p and p.
MSM_HD void fe32_reduce_full(fe32& a) {
  MSM_UNROLL
  for (int s = 2; s >= 0; --s) {
    uint32_t d[NW];
    uint32_t borrow = 0;
    MSM_UNROLL
    for (int i = 0; i < NW; ++i) {  // 4p < 2^256: word NW of p << s is 0
      const uint64_t t = (uint64_t)a.w[i] - p_shl_word(i, s) - borrow;
      d[i] = lo32(t);
      borrow = hi32(t) & 1u;
    }
    const uint32_t keep = 0u - borrow;
    MSM_UNROLL
    for (int i = 0; i < NW; ++i) a.w[i] = (a.w[i] & keep) | (d[i] & ~keep);
  }
}

MSM_HD void fe32_add(fe32& out, const fe32& a, const fe32& b) {
  uint32_t c = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    const uint64_t s = (uint64_t)a.w[i] + b.w[i] + c;
    out.w[i] = lo32(s);
    c = hi32(s);
  }
  // a + b < 2p < 2^255: no carry leaves the top word
  fe32_reduce_once(out);
}

MSM_HD void fe32_sub(fe32& out, const fe32& a, const fe32& b) {
  uint32_t borrow = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    const uint64_t t = (uint64_t)a.w[i] - b.w[i] - borrow;
    out.w[i] = lo32(t);
    borrow = hi32(t) & 1u;
  }
  const uint32_t addp = 0u - borrow;  // wrapped below zero: add p back
  uint32_t c = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    const uint64_t s = (uint64_t)out.w[i] + (p_word(i) & addp) + c;
    out.w[i] = lo32(s);
    c = hi32(s);
  }
}

MSM_HD void fe32_neg(fe32& out, const fe32& a) {
  fe32 z;
  fe32_zero(z);
  fe32_sub(out, z, a);
}

MSM_HD void fe32_double(fe32& out, const fe32& a) { fe32_add(out, a, a); }

// k * a for the small curve constant (3b), by the same double-and-add over
// fe32_add as field.cuh's fe_mul_small.
template <int K>
MSM_HD void fe32_mul_small(fe32& out, const fe32& a) {
  static_assert(K >= 1, "positive constant");
  fe32 acc = a;
  int started = 0;
  MSM_UNROLL
  for (int bit = 30; bit >= 0; --bit) {
    if (started) fe32_double(acc, acc);
    if ((K >> bit) & 1) {
      if (started) fe32_add(acc, acc, a);
      started = 1;
    }
  }
  out = acc;
}

// Montgomery product a b 2^-260 mod p; canonical in, canonical out.
MSM_HD void fe32_mul(fe32& out, const fe32& a, const fe32& b) {
  uint32_t t[NW];
  // word CIOS, no-carry form: t = a b 2^-256 + (0 or p), t < 2p
  MSM_UNROLL
  for (int j = 0; j < NW; ++j) t[j] = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = b.w[i];
    uint64_t s = (uint64_t)a.w[0] * bi + t[0];
    uint32_t A = hi32(s);
    const uint32_t t0 = lo32(s);
    const uint32_t m = t0 * N0W;
    uint32_t C = hi32((uint64_t)m * p_word(0) + t0);
    MSM_UNROLL
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)a.w[j] * bi + t[j] + A;
      A = hi32(s);
      const uint64_t u = (uint64_t)m * p_word(j) + lo32(s) + C;
      t[j - 1] = lo32(u);
      C = hi32(u);
    }
    t[NW - 1] = C + A;
  }
  // one 4-bit REDC step: t = (t + m p) / 16 < (2p + 15p) / 16 < 2p
  const uint32_t m = (t[0] * N0NIB) & 15u;
  uint32_t u[NW + 1];
  uint32_t c = 0;
  MSM_UNROLL
  for (int j = 0; j < NW; ++j) {
    const uint64_t v = (uint64_t)m * p_word(j) + t[j] + c;
    u[j] = lo32(v);
    c = hi32(v);
  }
  u[NW] = c;
  MSM_UNROLL
  for (int j = 0; j < NW; ++j) out.w[j] = (u[j] >> 4) | (u[j + 1] << 28);
  fe32_reduce_once(out);
}

MSM_HD void fe32_sqr(fe32& out, const fe32& a) { fe32_mul(out, a, a); }

// a^2 2^-260 mod p by a dedicated squaring: the symmetric schoolbook square
// (28 cross products, doubled, and 8 squares: 36 word products where
// fe32_mul's CIOS spends 64 on a b) into 16 words, then a word REDC by
// 2^256 (64 multiply-adds, as in fe32_mul) and the same 4-bit step and
// conditional subtract. Canonical in, canonical out. Used by kernel 9 only;
// fe32_sqr stays the general product for the other kernels.
MSM_HD void fe32_sqr_sym(fe32& out, const fe32& a) {
  uint32_t t[2 * NW];
  MSM_UNROLL
  for (int k = 0; k < 2 * NW; ++k) t[k] = 0;
  // cross products a_i a_j, i < j; row i's carry lands in the untouched t[i + NW]
  MSM_UNROLL
  for (int i = 0; i < NW - 1; ++i) {
    uint32_t c = 0;
    MSM_UNROLL
    for (int j = i + 1; j < NW; ++j) {
      const uint64_t v = (uint64_t)a.w[i] * a.w[j] + t[i + j] + c;
      t[i + j] = lo32(v);
      c = hi32(v);
    }
    t[i + NW] = c;
  }
  // doubled (the cross sum is below 2^507), plus the squares a_i^2 at 2i
  MSM_UNROLL
  for (int k = 2 * NW - 1; k > 0; --k) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  t[0] <<= 1;
  uint32_t c = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    const uint64_t sq = (uint64_t)a.w[i] * a.w[i];
    uint64_t v = (uint64_t)t[2 * i] + lo32(sq) + c;
    t[2 * i] = lo32(v);
    v = (uint64_t)t[2 * i + 1] + hi32(sq) + hi32(v);
    t[2 * i + 1] = lo32(v);
    c = hi32(v);
  }
  // REDC by 2^256: t = (a^2 + M p) / 2^256 < 2p; row i's carry out of
  // t[i + NW] goes into t[i + 1 + NW] with the next row
  uint32_t carry = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = t[i] * N0W;
    uint32_t C = hi32((uint64_t)m * p_word(0) + t[i]);
    MSM_UNROLL
    for (int j = 1; j < NW; ++j) {
      const uint64_t v = (uint64_t)m * p_word(j) + t[i + j] + C;
      t[i + j] = lo32(v);
      C = hi32(v);
    }
    const uint64_t v = (uint64_t)t[i + NW] + C + carry;
    t[i + NW] = lo32(v);
    carry = hi32(v);
  }
  // one 4-bit REDC step, as in fe32_mul
  const uint32_t m = (t[NW] * N0NIB) & 15u;
  uint32_t u[NW + 1];
  c = 0;
  MSM_UNROLL
  for (int j = 0; j < NW; ++j) {
    const uint64_t v = (uint64_t)m * p_word(j) + t[NW + j] + c;
    u[j] = lo32(v);
    c = hi32(v);
  }
  u[NW] = c;
  MSM_UNROLL
  for (int j = 0; j < NW; ++j) out.w[j] = (u[j] >> 4) | (u[j + 1] << 28);
  fe32_reduce_once(out);
}

// ---- repacking at the boundaries (shifts only) ----

// Canonical 13-bit limbs (field.cuh) -> words.
MSM_HD void fe32_from_limbs(fe32& out, const uint32_t (&v)[L]) {
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    uint32_t w = 0;
    MSM_UNROLL
    for (int j = 0; j < L; ++j) {
      const int s = W * j - 32 * i;  // bit of word i where limb j starts
      if (s >= 0 && s < 32) w |= v[j] << s;
      if (s < 0 && s > -W) w |= v[j] >> -s;
    }
    out.w[i] = w;
  }
}

// Words -> canonical 13-bit limbs v[0 .. L).
MSM_HD void fe32_to_limbs(uint32_t* v, const fe32& a) {
  MSM_UNROLL
  for (int j = 0; j < L; ++j) {
    const int lo = W * j, k = lo / 32, s = lo % 32;
    uint32_t x = 0;
    if (k < NW) {
      x = a.w[k] >> s;
      if (s + W > 32 && k + 1 < NW) x |= a.w[k + 1] << (32 - s);
    }
    v[j] = x & MASK;
  }
}

// One dense coordinate of the packed table (NW words, radix 2^32).
MSM_HD void fe32_load_dense(fe32& out, const int32_t* w) {
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) out.w[i] = (uint32_t)w[i];
}

// Balanced limbs (field.cuh fe_from_balanced's input: L signed limbs,
// value v = sum in[i] 2^(13 i), any limb within int32) -> canonical. A
// signed carry ripple gives v = U + c 2^260 with U in [0, 2^260) in 13-bit
// limbs; U < 128 p is reduced by conditional subtracts of 64p .. p, and
// each unit of c adds R mod p (c is -1 or 0 for v in (-R, R)). Canonical
// inputs (U < p, as every kernel writes them) skip the subtracts.
MSM_HD void fe32_from_balanced(fe32& out, const int32_t* in) {
  uint32_t v[L];
  int64_t c = 0;
  MSM_UNROLL
  for (int j = 0; j < L; ++j) {
    const int64_t s = (int64_t)in[j] + c;
    v[j] = (uint32_t)(s & MASK);
    c = s >> W;  // arithmetic shift: floor division
  }
  uint32_t u[NW + 1];  // U in words: 260 bits
  {
    fe32 lo;
    fe32_from_limbs(lo, v);
    MSM_UNROLL
    for (int i = 0; i < NW; ++i) u[i] = lo.w[i];
    u[NW] = v[L - 1] >> (32 * NW - W * (L - 1));
  }
  uint32_t below_p = 0;  // the borrow of U - p
  MSM_UNROLL
  for (int i = 0; i <= NW; ++i)
    below_p = hi32((uint64_t)u[i] - p_shl_word(i, 0) - below_p) & 1u;
  if (!below_p) {
    MSM_UNROLL
    for (int s = 6; s >= 0; --s) {  // subtract (p << s) when U >= p << s
      uint32_t d[NW + 1];
      uint32_t borrow = 0;
      MSM_UNROLL
      for (int i = 0; i <= NW; ++i) {
        const uint64_t t = (uint64_t)u[i] - p_shl_word(i, s) - borrow;
        d[i] = lo32(t);
        borrow = hi32(t) & 1u;
      }
      const uint32_t keep = 0u - borrow;
      MSM_UNROLL
      for (int i = 0; i <= NW; ++i) u[i] = (u[i] & keep) | (d[i] & ~keep);
    }
  }
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) out.w[i] = u[i];
  fe32 rm;
  fe32_mont_one(rm);
  for (; c < 0; ++c) fe32_sub(out, out, rm);
  for (; c > 0; --c) fe32_add(out, out, rm);
}

// Limb i of a value stored limbs-first at dst[i * stride].
MSM_HD void fe32_store_limbs_strided(int32_t* dst, int64_t stride,
                                     const fe32& a) {
  uint32_t v[L];
  fe32_to_limbs(v, a);
  MSM_UNROLL
  for (int i = 0; i < L; ++i) dst[i * stride] = (int32_t)v[i];
}

// Canonical 13-bit limbs stored limbs-first at src[i * stride] -> words.
MSM_HD void fe32_load_limbs_strided(fe32& out, const int32_t* src,
                                    int64_t stride) {
  uint32_t v[L];
  MSM_UNROLL
  for (int i = 0; i < L; ++i) v[i] = (uint32_t)src[i * stride];
  fe32_from_limbs(out, v);
}

}  // namespace msm
