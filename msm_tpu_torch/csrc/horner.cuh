// Kernel 7 (csrc/horner.cu), the Horner ladder on the word core, generic
// over the field: the window sums' load and the serial chain, with each
// formula's independent products spread over the lanes of a warp
// (csrc/lanes32.cuh). __host__ __device__, so the host C++ compiler builds
// it for the CPU tests; the kernel and its launch (HornerLaunch<F>) are in
// plain.cuh.
#pragma once

#include "lanes32.cuh"

namespace msm {

// Window sum s of w* [S, L] (balanced limbs) onto the word core.
template <class F>
MSM_HD void horner_load(pt32t<F>& p, const int32_t* wx, const int32_t* wy,
                        const int32_t* wz, int s) {
  const int64_t o = (int64_t)s * limb_count<F>();
  pt32_load_balanced(p, wx + o, wy + o, wz + o);
}

// sum_s 2^(chunk s) w[s] by Horner's rule: chunk (S - 1) doublings and
// S - 1 additions, each formula two products deep over the lanes of a warp
// (every lane runs the chain and ends with the same sum): (S - 1)(2 chunk +
// 2) products deep where one thread would take (S - 1)(8 chunk + 12).
template <class F>
MSM_HD void horner_chain(pt32t<F>& acc, const pt32t<F>* w, int S, int chunk) {
  acc = w[S - 1];
  for (int s = S - 2; s >= 0; --s) {
    for (int k = 0; k < chunk; ++k) pt32_double_lanes(acc, acc);
    pt32_add_lanes(acc, acc, w[s]);
  }
}

}  // namespace msm
