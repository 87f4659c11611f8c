// Kernel 9 (csrc/pairs.cuh k_mont_pow): the per-lane body on the word core,
// generic over the field, a^e for a Montgomery-form a, so pow(aR, e) =
// a^e R. __host__ __device__,
// so the host C++ compiler builds it for the CPU tests; every function
// inlines (MSM_HD).
//
// A fixed 4-bit window, most significant digit first: a table of a^1 ..
// a^15 (one squaring and 13 products), then per digit four squarings and,
// when the digit is not 0, one product by its table entry. For e = p - 2
// (254 bits, 64 digits, 59 of the lower 63 not 0) that is 253 squarings and
// 72 products (325) in place of the binary method's 254 and 110 (364). The
// squarings are fe32_sqr_sym. The exponent is uniform across the launch, so
// the digit's branch never diverges.
//
// The caller owns the table: POW_TABLE entries of F::NW words, word i of entry
// k (1 .. 15) at tab[((k - 1) * NW + i) * stride]. On the card it is
// shared memory laid out [entry][word][thread] (stride = the block's
// threads), so the threads of a warp read 32 consecutive words: no bank
// conflict. e: the exponent's 32-bit words, least significant first.
#pragma once

#include "fe32.cuh"

namespace msm {

constexpr int POW_WINDOW = 4;
constexpr int POW_TABLE = (1 << POW_WINDOW) - 1;  // a^1 .. a^15

template <class F>
MSM_HD void pow32_table_store(uint32_t* tab, int stride, int k,
                              const fe32t<F>& v) {
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) tab[((k - 1) * F::NW + i) * stride] = v.w[i];
}

template <class F>
MSM_HD void pow32_table_load(fe32t<F>& v, const uint32_t* tab, int stride,
                             int k) {
  MSM_UNROLL
  for (int i = 0; i < F::NW; ++i) v.w[i] = tab[((k - 1) * F::NW + i) * stride];
}

// Digit i (bits 4i .. 4i + 3) of the exponent.
MSM_HD int pow32_digit(const uint32_t* e, int i) {
  return (int)((e[i >> 3] >> (4 * (i & 7))) & 15u);
}

// out = a^e over the nbits low bits of e (e = 0 or nbits = 0: one; 0^e = 0
// for e >= 1).
template <class F>
MSM_HD void pow32_window(fe32t<F>& out, const fe32t<F>& a, const uint32_t* e,
                         int nbits, uint32_t* tab, int stride) {
  const int nd = (nbits + POW_WINDOW - 1) / POW_WINDOW;
  fe32t<F> acc;
  fe32_mont_one(acc);
  if (nd == 0) {
    out = acc;
    return;
  }
  fe32t<F> t = a;
  pow32_table_store(tab, stride, 1, t);
  MSM_ROLLED
  for (int k = 2; k <= POW_TABLE; ++k) {
    if (k == 2) {
      fe32_sqr_sym(t, a);
    } else {
      fe32_mul(t, t, a);
    }
    pow32_table_store(tab, stride, k, t);
  }
  const int top = pow32_digit(e, nd - 1);
  if (top) pow32_table_load(acc, tab, stride, top);
  MSM_ROLLED
  for (int i = nd - 2; i >= 0; --i) {
    MSM_UNROLL
    for (int s = 0; s < POW_WINDOW; ++s) fe32_sqr_sym(acc, acc);
    const int d = pow32_digit(e, i);
    if (d) {
      pow32_table_load(t, tab, stride, d);
      fe32_mul(acc, acc, t);
    }
  }
  out = acc;
}

}  // namespace msm
