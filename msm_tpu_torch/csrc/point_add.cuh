// Kernel 1 (csrc/point_add.cu): the bodies on the word core. __host__
// __device__, so the host C++ compiler builds them for the CPU tests.
//
// Row i of the six [B, L] balanced-limb inputs is added with RCB16
// Algorithm 7 and written as row i of the three [B, L] outputs in canonical
// 13-bit limbs: by one thread (point_add_row, pt32_add inlined), or, for
// small batches, by one warp that splits the 12 products over its lanes
// (point_add_row_lanes, csrc/lanes32.cuh pt32_add_lanes).
#pragma once

#include "lanes32.cuh"

namespace msm {

// One [L] limb row (80 B, 16 B aligned on the device: 80 = 5 x 16) onto the
// word core; on the device five 16-byte loads through the read-only cache.
MSM_HD void pa_load(fe32& out, const int32_t* src) {
#ifdef __CUDA_ARCH__
  int32_t raw[L];
  const int4* q = reinterpret_cast<const int4*>(src);
  MSM_UNROLL
  for (int k = 0; k < L / 4; ++k) {
    const int4 v = __ldg(q + k);
    raw[4 * k] = v.x;
    raw[4 * k + 1] = v.y;
    raw[4 * k + 2] = v.z;
    raw[4 * k + 3] = v.w;
  }
  fe32_from_balanced(out, raw);
#else
  fe32_from_balanced(out, src);
#endif
}

// One [L] row of canonical limbs; on the device five 16-byte stores.
MSM_HD void pa_store(int32_t* dst, const fe32& a) {
  uint32_t v[L];
  fe32_to_limbs(v, a);
#ifdef __CUDA_ARCH__
  int4* q = reinterpret_cast<int4*>(dst);
  MSM_UNROLL
  for (int k = 0; k < L / 4; ++k)
    q[k] = make_int4((int)v[4 * k], (int)v[4 * k + 1], (int)v[4 * k + 2],
                     (int)v[4 * k + 3]);
#else
  for (int k = 0; k < L; ++k) dst[k] = (int32_t)v[k];
#endif
}

MSM_HD void pa_load_points(pt32& p, pt32& q, const int32_t* ax,
                           const int32_t* ay, const int32_t* az,
                           const int32_t* bx, const int32_t* by,
                           const int32_t* bz, int64_t o) {
  pa_load(p.x, ax + o);
  pa_load(p.y, ay + o);
  pa_load(p.z, az + o);
  pa_load(q.x, bx + o);
  pa_load(q.y, by + o);
  pa_load(q.z, bz + o);
}

MSM_HD void point_add_row(const int32_t* ax, const int32_t* ay,
                          const int32_t* az, const int32_t* bx,
                          const int32_t* by, const int32_t* bz, int32_t* ox,
                          int32_t* oy, int32_t* oz, int64_t i) {
  const int64_t o = i * L;
  pt32 p, q, r;
  pa_load_points(p, q, ax, ay, az, bx, by, bz, o);
  pt32_add(r, p, q);
  pa_store(ox + o, r.x);
  pa_store(oy + o, r.y);
  pa_store(oz + o, r.z);
}

// Row i by a whole warp: every lane loads the row (one transaction per
// row) and ends with the sum; lanes 0, 1, 2 store x, y, z.
MSM_HD void point_add_row_lanes(const int32_t* ax, const int32_t* ay,
                                const int32_t* az, const int32_t* bx,
                                const int32_t* by, const int32_t* bz,
                                int32_t* ox, int32_t* oy, int32_t* oz,
                                int64_t i) {
  const int64_t o = i * L;
  pt32 p, q, r;
  pa_load_points(p, q, ax, ay, az, bx, by, bz, o);
  pt32_add_lanes(r, p, q);
#ifdef __CUDA_ARCH__
  const int lane = threadIdx.x & 31;
  if (lane == 0) pa_store(ox + o, r.x);
  if (lane == 1) pa_store(oy + o, r.y);
  if (lane == 2) pa_store(oz + o, r.z);
#else
  pa_store(ox + o, r.x);
  pa_store(oy + o, r.y);
  pa_store(oz + o, r.z);
#endif
}

}  // namespace msm
