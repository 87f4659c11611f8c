// Row offsets (kernel 5, csrc/prefix.cu): the per-thread bodies of the
// first and last of its three launches, on the word core, generic over the
// field. __host__ __device__, so the host C++ compiler builds them for the
// CPU tests; the three kernels and their launch (RowOffsetsLaunch<F>) are
// in plain.cuh.
//
// Thread j of block b owns the K contiguous lanes r0 = (b * BLOCK + j) * K
// .. r0 + K - 1 of one subtask. Lane totals t* are [G, L, R] limbs-first in
// balanced limbs; prefixes o* are [G, R, L] in canonical limbs.
#pragma once

#include "curve32.cuh"

namespace msm {

// Lane r of subtask g of t* [G, L, R] (balanced limbs) onto the word core.
template <class F>
MSM_HD void ro_load_lane(pt32t<F>& p, const int32_t* tx, const int32_t* ty,
                         const int32_t* tz, int64_t g, int R, int r) {
  const int64_t o = g * F::L * R + r;
  fe32_load_balanced_strided(p.x, tx + o, R);
  fe32_load_balanced_strided(p.y, ty + o, R);
  fe32_load_balanced_strided(p.z, tz + o, R);
}

// s = the sum of the thread's K lanes r0 .. r0 + K - 1.
template <class F>
MSM_HD void ro_thread_total(pt32t<F>& s, const int32_t* tx, const int32_t* ty,
                            const int32_t* tz, int64_t g, int R, int r0,
                            int K) {
  ro_load_lane(s, tx, ty, tz, g, R, r0);
  MSM_ROLLED
  for (int c = 1; c < K; ++c) {
    pt32t<F> v;
    ro_load_lane(v, tx, ty, tz, g, R, r0 + c);
    pt32_add(s, s, v);
  }
}

// Writes the exclusive prefixes of the thread's K lanes, the first being
// acc (the prefix of lane r0), re-accumulating the lanes.
template <class F>
MSM_HD void ro_thread_write(pt32t<F> acc, const int32_t* tx, const int32_t* ty,
                            const int32_t* tz, int32_t* ox, int32_t* oy,
                            int32_t* oz, int64_t g, int R, int r0, int K) {
  MSM_ROLLED
  for (int c = 0; c < K; ++c) {
    const int64_t o = (g * R + r0 + c) * F::L;
    pt32_store_limbs(ox + o, oy + o, oz + o, 1, acc);
    if (c + 1 < K) {
      pt32t<F> v;
      ro_load_lane(v, tx, ty, tz, g, R, r0 + c);
      pt32_add(acc, acc, v);
    }
  }
}

// A point of canonical limbs (as the kernels write them), one [L] row per
// coordinate: no reduction.
template <class F>
MSM_HD void pt32_load_canonical(pt32t<F>& p, const int32_t* x,
                                const int32_t* y, const int32_t* z) {
  fe32_load_limbs_strided(p.x, x, 1);
  fe32_load_limbs_strided(p.y, y, 1);
  fe32_load_limbs_strided(p.z, z, 1);
}

}  // namespace msm
