// Kernel 6 (csrc/point_total.cu): the per-thread bodies on the word core,
// generic over the field. __host__ __device__, so the host C++ compiler
// builds them for the CPU tests, which also model the kernel's shuffle
// trees over these bodies; the two kernels and their launch
// (PointTotalLaunch<F>) are in plain.cuh.
//
// Inputs p* [G, N, L] (balanced limbs). Thread j of subtask g sums the
// contiguous run of points [j k, min((j + 1) k, N)); a block's partial sum
// goes to part [G, nb, pt_words<F>] as the word core's canonical words, and
// lane l of the finishing warp sums partials l, l + 32, ... of its subtask.
#pragma once

#include "point_add.cuh"

namespace msm {

// a pt32t as words: x, then y, then z
template <class F>
constexpr int pt_words = 3 * F::NW;

// Thread j's run of subtask g: identity when the run is empty.
template <class F>
MSM_HD void pt_total_run(pt32t<F>& s, const int32_t* px, const int32_t* py,
                         const int32_t* pz, int64_t g, int64_t N, int k,
                         int64_t j) {
  const int64_t lo = j * k, hi = lo + k < N ? lo + k : N;
  if (lo >= hi) {
    pt32_identity(s);
    return;
  }
  constexpr int L = F::L;
  int64_t o = (g * N + lo) * L;
  pa_load(s.x, px + o);
  pa_load(s.y, py + o);
  pa_load(s.z, pz + o);
  MSM_ROLLED
  for (int64_t i = lo + 1; i < hi; ++i) {
    o += L;
    pt32t<F> v;
    pa_load(v.x, px + o);
    pa_load(v.y, py + o);
    pa_load(v.z, pz + o);
    pt32_add(s, s, v);
  }
}

template <class F>
MSM_HD void pt32_store_words(uint32_t* dst, const pt32t<F>& p) {
  constexpr int NW = F::NW;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    dst[i] = p.x.w[i];
    dst[NW + i] = p.y.w[i];
    dst[2 * NW + i] = p.z.w[i];
  }
}

template <class F>
MSM_HD void pt32_load_words(pt32t<F>& p, const uint32_t* src) {
  constexpr int NW = F::NW;
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    p.x.w[i] = src[i];
    p.y.w[i] = src[NW + i];
    p.z.w[i] = src[2 * NW + i];
  }
}

// Lane `lane` of `lanes` finishing subtask g: the sum of its partials
// lane, lane + lanes, ... of part [G, nb, pt_words<F>]; identity when none.
template <class F>
MSM_HD void pt_total_partials(pt32t<F>& s, const uint32_t* part, int64_t g,
                              int nb, int lane, int lanes) {
  constexpr int W = pt_words<F>;
  if (lane >= nb) {
    pt32_identity(s);
    return;
  }
  pt32_load_words(s, part + (g * nb + lane) * W);
  MSM_ROLLED
  for (int i = lane + lanes; i < nb; i += lanes) {
    pt32t<F> v;
    pt32_load_words(v, part + (g * nb + i) * W);
    pt32_add(s, s, v);
  }
}

}  // namespace msm
