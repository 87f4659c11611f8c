// Base-field arithmetic in 32-bit words, generic over the field (a traits
// type of fields.cuh): the word core of every kernel -- the point add
// (kernel 1), the point conversion (2), the scan (4), the row offsets (5),
// the point total (6), the Horner ladder (7), BPR phase 1 (8), the Fermat
// inversion (9) and the four pair kernels (10-13) -- for every curve. The
// BN254 names at the end of this file (fe32, NW) serve the host tests and
// the variant scripts; no kernel uses them.
//
// An `fe32t<F>` is F::NW words, least significant first, CANONICAL (value
// in [0, p)), in the Montgomery domain of the F::W-bit limbs the kernels
// exchange: R = 2^(W L) (BN254: 2^260 at 13-bit limbs, 2^264 at 12). Kernel
// boundaries keep canonical W-bit limbs; the kernels repack with shifts only
// (fe32_from_limbs, fe32_to_limbs), and the packed table's dense words
// (radix 2^32, F::NW a coordinate) are already this form. A canonical
// value is unique, so a kernel on this core writes exactly the limbs any
// other exact implementation writes.
//
// The R = 2^(W L) product is a word-level CIOS with N0W = -p^-1 mod 2^32
// (a REDC by 2^(32 NW), leaving t < 2p), one TAIL-bit REDC step (m = t N0T
// mod 2^TAIL, t = (t + m p) / 2^TAIL, again < 2p; BN254: 4 bits at 13-bit
// limbs; none where TAIL is 0, BLS12-377 at 12) and one conditional subtract: a b R^-1 mod p, with no product spent on changing
// domains. Where the top word of p is below 2^31 - 1 the CIOS is the
// "no-carry" form (the running sum never needs a word NW); secp256k1
// (F::CARRY) keeps the carry word, and its sums below 2p carry a bit 2^256
// that the conditional subtracts take into account. NW x NW word
// multiply-adds for a b and as many for m p.
//
// Portable code: 64-bit accumulators that nvcc lowers to IMAD.WIDE.U32, so
// g++ builds this header for the CPU tests and checks the arithmetic the
// card runs. Every function inlines (MSM_HD): kernels on this core have no
// out-of-line call.
#pragma once

#include "field.cuh"
#include "fields.cuh"

namespace msm {

template <class F>
struct fe32t {
  uint32_t w[F::NW];
};

// Word i (of NW + 1) of p << s, 0 <= s < 32.
template <class F>
MSM_HD uint32_t p_shl_word(int i, int s) {
  const uint32_t lo = i < F::NW ? F::p(i) << s : 0u;
  const uint32_t hi = (i > 0 && s > 0) ? F::p(i - 1) >> (32 - s) : 0u;
  return lo | hi;
}

template <class F>
MSM_HD void fe32_zero(fe32t<F>& a) {
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) a.w[i] = 0;
}

template <class F>
MSM_HD void fe32_mont_one(fe32t<F>& a) {
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) a.w[i] = F::r(i);
}

template <class F>
MSM_HD void fe32_const_r2(fe32t<F>& a) {
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) a.w[i] = F::r2(i);
}

MSM_HD uint32_t lo32(uint64_t v) { return (uint32_t)v; }
MSM_HD uint32_t hi32(uint64_t v) { return (uint32_t)(v >> 32); }

// a <- a - p when a >= p (a < 2^(32 NW)), branch-free.
template <class F>
MSM_HD void fe32_reduce_once(fe32t<F>& a) {
  uint32_t d[F::NW];
  uint32_t borrow = 0;
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) {
    const uint64_t t = (uint64_t)a.w[i] - F::p(i) - borrow;
    d[i] = lo32(t);
    borrow = hi32(t) & 1u;
  }
  const uint32_t keep = 0u - borrow;  // all ones: a < p, keep a
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) a.w[i] = (a.w[i] & keep) | (d[i] & ~keep);
}

// a + hi 2^(32 NW) <- that minus p when it is >= p (the value below 2p,
// hi 0 or 1): the carry word's conditional subtract (F::CARRY).
template <class F>
MSM_HD void fe32_reduce_once_hi(fe32t<F>& a, uint32_t hi) {
  uint32_t d[F::NW];
  uint32_t borrow = 0;
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) {
    const uint64_t t = (uint64_t)a.w[i] - F::p(i) - borrow;
    d[i] = lo32(t);
    borrow = hi32(t) & 1u;
  }
  const uint32_t keep = 0u - (borrow & (hi ^ 1u));  // below p: keep a
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) a.w[i] = (a.w[i] & keep) | (d[i] & ~keep);
}

// a <- a mod p for any a < 2^(32 NW): branch-free conditional subtracts of
// p 2^REDUCE_TOP .. p (BN254: 4p, 2p, p), each of which fits NW words.
template <class F>
MSM_HD void fe32_reduce_full(fe32t<F>& a) {
  MSM_UNROLL
  for (int s = F::REDUCE_TOP; s >= 0; --s) {
    uint32_t d[F::NW];
    uint32_t borrow = 0;
    MSM_UNROLL
    for (int i = 0; i < F::NW; ++i) {  // p << s < 2^(32 NW): word NW is 0
      const uint64_t t = (uint64_t)a.w[i] - p_shl_word<F>(i, s) - borrow;
      d[i] = lo32(t);
      borrow = hi32(t) & 1u;
    }
    const uint32_t keep = 0u - borrow;
    MSM_UNROLL
    for (int i = 0; i < F::NW; ++i) a.w[i] = (a.w[i] & keep) | (d[i] & ~keep);
  }
}

template <class F>
MSM_HD void fe32_add(fe32t<F>& out, const fe32t<F>& a, const fe32t<F>& b) {
  uint32_t c = 0;
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) {
    const uint64_t s = (uint64_t)a.w[i] + b.w[i] + c;
    out.w[i] = lo32(s);
    c = hi32(s);
  }
  if constexpr (F::CARRY) {
    fe32_reduce_once_hi(out, c);
  } else {
    // a + b < 2p < 2^(32 NW): no carry leaves the top word
    fe32_reduce_once(out);
  }
}

template <class F>
MSM_HD void fe32_sub(fe32t<F>& out, const fe32t<F>& a, const fe32t<F>& b) {
  uint32_t borrow = 0;
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) {
    const uint64_t t = (uint64_t)a.w[i] - b.w[i] - borrow;
    out.w[i] = lo32(t);
    borrow = hi32(t) & 1u;
  }
  const uint32_t addp = 0u - borrow;  // wrapped below zero: add p back
  uint32_t c = 0;
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) {
    const uint64_t s = (uint64_t)out.w[i] + (F::p(i) & addp) + c;
    out.w[i] = lo32(s);
    c = hi32(s);
  }
}

template <class F>
MSM_HD void fe32_neg(fe32t<F>& out, const fe32t<F>& a) {
  fe32t<F> z;
  fe32_zero(z);
  fe32_sub(out, z, a);
}

template <class F>
MSM_HD void fe32_double(fe32t<F>& out, const fe32t<F>& a) { fe32_add(out, a, a); }

// k * a for a small positive constant, by a double-and-add over fe32_add.
template <int K, class F>
MSM_HD void fe32_mul_small(fe32t<F>& out, const fe32t<F>& a) {
  static_assert(K >= 1, "positive constant");
  fe32t<F> acc = a;
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

// 3b a (the curve constant of the RCB16 formulas): F::B3 a, or -(|B3| a)
// where 3b is a small negative residue (Grumpkin: 3b = -51).
template <class F>
MSM_HD void fe32_mul_b3(fe32t<F>& out, const fe32t<F>& a) {
  if constexpr (F::B3 > 0) {
    fe32_mul_small<F::B3>(out, a);
  } else {
    fe32_mul_small<-F::B3>(out, a);
    fe32_neg(out, out);
  }
}

// The last REDC step and conditional subtract of a product: t (NW words,
// plus its bit 2^(32 NW) in `top` under F::CARRY; t < 2p) -> (t + m p) /
// 2^TAIL with m = t N0T mod 2^TAIL, below 2p, then below p. At TAIL = 0
// (R = 2^(32 NW)) t is the product already: only the subtract is left.
template <class F>
MSM_HD void fe32_redc_tail(fe32t<F>& out, const uint32_t* t, uint32_t top) {
  constexpr int NW = F::NW, TAIL = F::TAIL;
  static_assert(0 <= TAIL && TAIL < 32, "the tail step is below a word");
  uint32_t hi = top;  // bit 2^(32 NW) of out's value (F::CARRY)
  if constexpr (TAIL == 0) {
    MSM_UNROLL
    for (int j = 0; j < NW; ++j) out.w[j] = t[j];
  } else {
    const uint32_t m = (t[0] * F::N0T) & ((1u << TAIL) - 1u);
    uint32_t u[NW + 1];
    uint32_t c = 0;
    MSM_UNROLL
    for (int j = 0; j < NW; ++j) {
      const uint64_t v = (uint64_t)m * F::p(j) + t[j] + c;
      u[j] = lo32(v);
      c = hi32(v);
    }
    u[NW] = F::CARRY ? c + top : c;
    MSM_UNROLL
    for (int j = 0; j < NW; ++j) out.w[j] = (u[j] >> TAIL) | (u[j + 1] << (32 - TAIL));
    hi = u[NW] >> TAIL;
  }
  if constexpr (F::CARRY) {
    fe32_reduce_once_hi(out, hi);
  } else {
    fe32_reduce_once(out);
  }
}

// Montgomery product a b R^-1 mod p; canonical in, canonical out.
template <class F>
MSM_HD void fe32_mul(fe32t<F>& out, const fe32t<F>& a, const fe32t<F>& b) {
  constexpr int NW = F::NW;
  if constexpr (F::CARRY) {
    // word CIOS with the carry words t[NW], t[NW + 1]: t < 2p on exit
    uint32_t t[NW + 2];
    MSM_UNROLL
    for (int j = 0; j < NW + 2; ++j) t[j] = 0;
    MSM_UNROLL
    for (int i = 0; i < NW; ++i) {
      const uint32_t bi = b.w[i];
      uint32_t C = 0;
      MSM_UNROLL
      for (int j = 0; j < NW; ++j) {
        const uint64_t s = (uint64_t)a.w[j] * bi + t[j] + C;
        t[j] = lo32(s);
        C = hi32(s);
      }
      uint64_t s = (uint64_t)t[NW] + C;
      t[NW] = lo32(s);
      t[NW + 1] = hi32(s);
      const uint32_t m = t[0] * F::N0W;
      C = hi32((uint64_t)m * F::p(0) + t[0]);
      MSM_UNROLL
      for (int j = 1; j < NW; ++j) {
        s = (uint64_t)m * F::p(j) + t[j] + C;
        t[j - 1] = lo32(s);
        C = hi32(s);
      }
      s = (uint64_t)t[NW] + C;
      t[NW - 1] = lo32(s);
      t[NW] = t[NW + 1] + hi32(s);
    }
    fe32_redc_tail(out, t, t[NW]);
  } else {
    uint32_t t[NW];
    // word CIOS, no-carry form: t = a b 2^(-32 NW) + (0 or p), t < 2p
    MSM_UNROLL
    for (int j = 0; j < NW; ++j) t[j] = 0;
    MSM_UNROLL
    for (int i = 0; i < NW; ++i) {
      const uint32_t bi = b.w[i];
      uint64_t s = (uint64_t)a.w[0] * bi + t[0];
      uint32_t A = hi32(s);
      const uint32_t t0 = lo32(s);
      const uint32_t m = t0 * F::N0W;
      uint32_t C = hi32((uint64_t)m * F::p(0) + t0);
      MSM_UNROLL
      for (int j = 1; j < NW; ++j) {
        s = (uint64_t)a.w[j] * bi + t[j] + A;
        A = hi32(s);
        const uint64_t u = (uint64_t)m * F::p(j) + lo32(s) + C;
        t[j - 1] = lo32(u);
        C = hi32(u);
      }
      t[NW - 1] = C + A;
    }
    fe32_redc_tail(out, t, 0u);
  }
}

template <class F>
MSM_HD void fe32_sqr(fe32t<F>& out, const fe32t<F>& a) { fe32_mul(out, a, a); }

// a^2 R^-1 mod p by a dedicated squaring: the symmetric schoolbook square
// (NW (NW - 1) / 2 cross products, doubled, and NW squares: 36 word
// products at NW = 8 where fe32_mul's CIOS spends 64 on a b) into 2 NW
// words, then a word REDC by 2^(32 NW) (NW^2 multiply-adds, as in
// fe32_mul) and the same TAIL-bit step and conditional subtract. Canonical
// in, canonical out. Used by kernel 9 only; fe32_sqr stays the general
// product for the other kernels.
template <class F>
MSM_HD void fe32_sqr_sym(fe32t<F>& out, const fe32t<F>& a) {
  constexpr int NW = F::NW;
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
  // doubled (the cross sum is below a^2 / 2), plus the squares a_i^2 at 2i
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
  // REDC by 2^(32 NW): t = (a^2 + M p) / 2^(32 NW) < 2p; row i's carry out
  // of t[i + NW] goes into t[i + 1 + NW] with the next row, and the last
  // row's (0 unless F::CARRY) is bit 2^(32 NW) of the result
  uint32_t carry = 0;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = t[i] * F::N0W;
    uint32_t C = hi32((uint64_t)m * F::p(0) + t[i]);
    MSM_UNROLL
    for (int j = 1; j < NW; ++j) {
      const uint64_t v = (uint64_t)m * F::p(j) + t[i + j] + C;
      t[i + j] = lo32(v);
      C = hi32(v);
    }
    const uint64_t v = (uint64_t)t[i + NW] + C + carry;
    t[i + NW] = lo32(v);
    carry = hi32(v);
  }
  fe32_redc_tail(out, t + NW, carry);
}

// ---- repacking at the boundaries (shifts only) ----

// Words 0 .. N - 1 of the value held in L W-bit limbs (limbs below 2^W).
template <int W, int N, int L>
MSM_HD void limbs_to_words(uint32_t (&out)[N], const uint32_t (&v)[L]) {
  MSM_UNROLL
  for (int i = 0; i < N; ++i) {
    uint32_t w = 0;
    MSM_UNROLL
    for (int j = 0; j < L; ++j) {
      const int s = W * j - 32 * i;  // bit of word i where limb j starts
      if (s >= 0 && s < 32) w |= v[j] << s;
      if (s < 0 && s > -W) w |= v[j] >> -s;
    }
    out[i] = w;
  }
}

// Canonical F::W-bit limbs -> words.
template <class F>
MSM_HD void fe32_from_limbs(fe32t<F>& out, const uint32_t (&v)[F::L]) {
  limbs_to_words<F::W>(out.w, v);
}

// Words -> canonical F::W-bit limbs v[0 .. L).
template <class F>
MSM_HD void fe32_to_limbs(uint32_t* v, const fe32t<F>& a) {
  constexpr int W = F::W;
  MSM_UNROLL
  for (int j = 0; j < F::L; ++j) {
    const int lo = W * j, k = lo / 32, s = lo % 32;
    uint32_t x = 0;
    if (k < F::NW) {
      x = a.w[k] >> s;
      if (s + W > 32 && k + 1 < F::NW) x |= a.w[k + 1] << (32 - s);
    }
    v[j] = x & F::MASK;
  }
}

// One dense coordinate of the packed table (NW words, radix 2^32).
template <class F>
MSM_HD void fe32_load_dense(fe32t<F>& out, const int32_t* w) {
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) out.w[i] = (uint32_t)w[i];
}

// Balanced limbs (L signed limbs, value v = sum in[i] 2^(W i), any limb
// within int32) -> canonical. A signed carry ripple gives v = U + c R with
// U in [0, R) in W-bit limbs; U < 2^(BALANCED_TOP + 1) p is reduced by
// conditional subtracts of p 2^BALANCED_TOP .. p on NW + 1 words, and each
// unit of c adds R mod p (c is -1 or 0 for v in (-R, R)). Canonical inputs
// (U < p, as every kernel writes them) skip the subtracts.
template <class F>
MSM_HD void fe32_from_balanced(fe32t<F>& out, const int32_t* in) {
  constexpr int NW = F::NW, L = F::L;
  uint32_t v[L];
  int64_t c = 0;
  MSM_UNROLL
  for (int j = 0; j < L; ++j) {
    const int64_t s = (int64_t)in[j] + c;
    v[j] = (uint32_t)(s & F::MASK);
    c = s >> F::W;  // arithmetic shift: floor division
  }
  uint32_t u[NW + 1];  // U in words: W L bits
  limbs_to_words<F::W>(u, v);
  uint32_t below_p = 0;  // the borrow of U - p
  MSM_UNROLL
  for (int i = 0; i <= NW; ++i)
    below_p = hi32((uint64_t)u[i] - p_shl_word<F>(i, 0) - below_p) & 1u;
  if (!below_p) {
    MSM_UNROLL
    for (int s = F::BALANCED_TOP; s >= 0; --s) {  // U -= p << s when U >= p << s
      uint32_t d[NW + 1];
      uint32_t borrow = 0;
      MSM_UNROLL
      for (int i = 0; i <= NW; ++i) {
        const uint64_t t = (uint64_t)u[i] - p_shl_word<F>(i, s) - borrow;
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
  fe32t<F> rm;
  fe32_mont_one(rm);
  for (; c < 0; ++c) fe32_sub(out, out, rm);
  for (; c > 0; --c) fe32_add(out, out, rm);
}

// Limb i of a value stored limbs-first at dst[i * stride].
template <class F>
MSM_HD void fe32_store_limbs_strided(int32_t* dst, int64_t stride,
                                     const fe32t<F>& a) {
  uint32_t v[F::L];
  fe32_to_limbs(v, a);
  MSM_UNROLL
  for (int i = 0; i < F::L; ++i) dst[i * stride] = (int32_t)v[i];
}

// Canonical W-bit limbs stored limbs-first at src[i * stride] -> words.
template <class F>
MSM_HD void fe32_load_limbs_strided(fe32t<F>& out, const int32_t* src,
                                    int64_t stride) {
  uint32_t v[F::L];
  MSM_UNROLL
  for (int i = 0; i < F::L; ++i) v[i] = (uint32_t)src[i * stride];
  fe32_from_limbs(out, v);
}

// Balanced limbs stored limbs-first at src[i * stride] -> canonical words.
template <class F>
MSM_HD void fe32_load_balanced_strided(fe32t<F>& out, const int32_t* src,
                                       int64_t stride) {
  int32_t v[F::L];
  MSM_UNROLL
  for (int i = 0; i < F::L; ++i) v[i] = src[i * stride];
  fe32_from_balanced(out, v);
}

// ---- rows of int32 in device memory ----

// The alignment (bytes) that row_load and row_store need of a row of N
// int32: the widest vector that N words split into.
template <int N>
constexpr int row_align = N % 4 == 0 ? 16 : N % 2 == 0 ? 8 : 4;

// A row of N int32 (row_align<N> aligned); on the device in 16-byte (or
// 8-byte, or 4-byte) loads through the read-only cache.
template <int N>
MSM_HD void row_load(int32_t (&raw)[N], const int32_t* src) {
#ifdef __CUDA_ARCH__
  if constexpr (N % 4 == 0) {
    const int4* q = reinterpret_cast<const int4*>(src);
    MSM_UNROLL
    for (int k = 0; k < N / 4; ++k) {
      const int4 v = __ldg(q + k);
      raw[4 * k] = v.x;
      raw[4 * k + 1] = v.y;
      raw[4 * k + 2] = v.z;
      raw[4 * k + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
    const int2* q = reinterpret_cast<const int2*>(src);
    MSM_UNROLL
    for (int k = 0; k < N / 2; ++k) {
      const int2 v = __ldg(q + k);
      raw[2 * k] = v.x;
      raw[2 * k + 1] = v.y;
    }
  } else {
    MSM_UNROLL
    for (int k = 0; k < N; ++k) raw[k] = __ldg(src + k);
  }
#else
  for (int k = 0; k < N; ++k) raw[k] = src[k];
#endif
}

// A row of N int32 (row_align<N> aligned); on the device in the same
// vector widths as row_load.
template <int N>
MSM_HD void row_store(int32_t* dst, const uint32_t (&v)[N]) {
#ifdef __CUDA_ARCH__
  if constexpr (N % 4 == 0) {
    int4* q = reinterpret_cast<int4*>(dst);
    MSM_UNROLL
    for (int k = 0; k < N / 4; ++k)
      q[k] = make_int4((int)v[4 * k], (int)v[4 * k + 1], (int)v[4 * k + 2],
                       (int)v[4 * k + 3]);
  } else if constexpr (N % 2 == 0) {
    int2* q = reinterpret_cast<int2*>(dst);
    MSM_UNROLL
    for (int k = 0; k < N / 2; ++k)
      q[k] = make_int2((int)v[2 * k], (int)v[2 * k + 1]);
  } else {
    MSM_UNROLL
    for (int k = 0; k < N; ++k) dst[k] = (int32_t)v[k];
  }
#else
  for (int k = 0; k < N; ++k) dst[k] = (int32_t)v[k];
#endif
}

// ---- BN254 names, for the host tests and the variant scripts ----

using fe32 = fe32t<FpBn254>;
constexpr int NW = FpBn254::NW;
static_assert(FpBn254::W != W || FpBn254::L == L,
              "the 13-bit core's limb count is BN254's at 13-bit limbs");

MSM_HD uint32_t p_word(int i) { return FpBn254::p(i); }

}  // namespace msm
