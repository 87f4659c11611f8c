// Kernel 6 (csrc/point_total.cu): the per-thread bodies on the word core.
// __host__ __device__, so the host C++ compiler builds them for the CPU
// tests, which also model the kernel's shuffle trees over these bodies.
//
// Inputs p* [G, N, L] (balanced limbs). Thread j of subtask g sums the
// contiguous run of points [j k, min((j + 1) k, N)); a block's partial sum
// goes to part [G, nb, PT_WORDS] as the word core's canonical words, and
// lane l of the finishing warp sums partials l, l + 32, ... of its subtask.
#pragma once

#include "point_add.cuh"

namespace msm {

constexpr int PT_WORDS = 3 * NW;  // a pt32 as words: x, then y, then z

// Thread j's run of subtask g: identity when the run is empty.
MSM_HD void pt_total_run(pt32& s, const int32_t* px, const int32_t* py,
                         const int32_t* pz, int64_t g, int64_t N, int k,
                         int64_t j) {
  const int64_t lo = j * k, hi = lo + k < N ? lo + k : N;
  if (lo >= hi) {
    pt32_identity(s);
    return;
  }
  int64_t o = (g * N + lo) * L;
  pa_load(s.x, px + o);
  pa_load(s.y, py + o);
  pa_load(s.z, pz + o);
  MSM_ROLLED
  for (int64_t i = lo + 1; i < hi; ++i) {
    o += L;
    pt32 v;
    pa_load(v.x, px + o);
    pa_load(v.y, py + o);
    pa_load(v.z, pz + o);
    pt32_add(s, s, v);
  }
}

MSM_HD void pt32_store_words(uint32_t* dst, const pt32& p) {
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    dst[i] = p.x.w[i];
    dst[NW + i] = p.y.w[i];
    dst[2 * NW + i] = p.z.w[i];
  }
}

MSM_HD void pt32_load_words(pt32& p, const uint32_t* src) {
  MSM_UNROLL
  for (int i = 0; i < NW; ++i) {
    p.x.w[i] = src[i];
    p.y.w[i] = src[NW + i];
    p.z.w[i] = src[2 * NW + i];
  }
}

// Lane `lane` of `lanes` finishing subtask g: the sum of its partials
// lane, lane + lanes, ... of part [G, nb, PT_WORDS]; identity when none.
MSM_HD void pt_total_partials(pt32& s, const uint32_t* part, int64_t g, int nb,
                              int lane, int lanes) {
  if (lane >= nb) {
    pt32_identity(s);
    return;
  }
  pt32_load_words(s, part + (g * nb + lane) * PT_WORDS);
  MSM_ROLLED
  for (int i = lane + lanes; i < nb; i += lanes) {
    pt32 v;
    pt32_load_words(v, part + (g * nb + i) * PT_WORDS);
    pt32_add(s, s, v);
  }
}

}  // namespace msm
