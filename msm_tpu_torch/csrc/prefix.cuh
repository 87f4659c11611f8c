// Row offsets (kernel 5, csrc/prefix.cu): the per-thread bodies of the
// first and last of its three launches. __host__ __device__, so the host
// C++ compiler builds them for the CPU tests.
//
// Thread j of block b owns the K contiguous lanes r0 = (b * BLOCK + j) * K
// .. r0 + K - 1 of one subtask. Lane totals t* are [G, L, R] limbs-first in
// balanced limbs; prefixes o* are [G, R, L] in canonical limbs.
#pragma once

#include "curve.cuh"

namespace msm {

// Limb i of K neighbouring lanes at p (4K-byte aligned for K > 1): on the
// device one vector load per thread, so a warp's loads of a limb row are
// contiguous.
template <int K>
MSM_HD void ro_load_row(int32_t (&raw)[K][L], int i, const int32_t* p) {
#ifdef __CUDA_ARCH__
  if constexpr (K == 1) {
    raw[0][i] = p[0];
  } else if constexpr (K == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    raw[0][i] = v.x;
    raw[1][i] = v.y;
  } else {
    MSM_UNROLL
    for (int q = 0; q < K; q += 4) {
      const int4 v = *reinterpret_cast<const int4*>(p + q);
      raw[q][i] = v.x;
      raw[q + 1][i] = v.y;
      raw[q + 2][i] = v.z;
      raw[q + 3][i] = v.w;
    }
  }
#else
  for (int c = 0; c < K; ++c) raw[c][i] = p[c];
#endif
}

// One coordinate (member m) of K lanes from src = &t[g, 0, r0].
template <int K>
MSM_HD void ro_load_coord(point (&p)[K], fe point::*m, const int32_t* src,
                          int R) {
  int32_t raw[K][L];
  MSM_UNROLL
  for (int i = 0; i < L; ++i) ro_load_row<K>(raw, i, src + (int64_t)i * R);
  MSM_UNROLL
  for (int c = 0; c < K; ++c) fe_from_balanced(p[c].*m, raw[c]);
}

template <int K>
MSM_HD void ro_load_lanes(point (&p)[K], const int32_t* tx, const int32_t* ty,
                          const int32_t* tz, int64_t g, int R, int r0) {
  const int64_t o = g * L * R + r0;
  ro_load_coord<K>(p, &point::x, tx + o, R);
  ro_load_coord<K>(p, &point::y, ty + o, R);
  ro_load_coord<K>(p, &point::z, tz + o, R);
}

// s = the sum of the thread's K lanes.
template <int K>
MSM_HD void ro_thread_total(point& s, const int32_t* tx, const int32_t* ty,
                            const int32_t* tz, int64_t g, int R, int r0) {
  point p[K];
  ro_load_lanes<K>(p, tx, ty, tz, g, R, r0);
  s = p[0];
  for (int c = 1; c < K; ++c) pt_add(s, s, p[c]);
}

// Writes the exclusive prefixes of the thread's K lanes, the first being
// acc (the prefix of lane r0), re-accumulating the lanes.
template <int K>
MSM_HD void ro_thread_write(point acc, const int32_t* tx, const int32_t* ty,
                            const int32_t* tz, int32_t* ox, int32_t* oy,
                            int32_t* oz, int64_t g, int R, int r0) {
  point p[K];
  if (K > 1) ro_load_lanes<K>(p, tx, ty, tz, g, R, r0);
  for (int c = 0; c < K; ++c) {
    const int64_t o = (g * R + r0 + c) * L;
    pt_store(ox + o, oy + o, oz + o, 1, acc);
    if (c + 1 < K) pt_add(acc, acc, p[c]);
  }
}

// A point of canonical limbs (as the kernels write them), one [L] row per
// coordinate: no conversion.
MSM_HD void pt_load_canonical(point& p, const int32_t* x, const int32_t* y,
                              const int32_t* z) {
  fe_load_strided(p.x, x, 1);
  fe_load_strided(p.y, y, 1);
  fe_load_strided(p.z, z, 1);
}

}  // namespace msm
